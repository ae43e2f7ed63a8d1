"""Sharded Form A training on a world of CPU ranks (gloo): the port's
`FusedExecutor(mesh=make_sized_mesh(8, 2))` against the port's unsharded
step and against the reference's run on `make_sized_mesh(8, 2)` (8 fake CPU
devices, `tests/conftest.py:run_py`), and `reshard_state` across meshes.

Each test writes its ranks' code into `tmp_path` and runs it in a fresh
python that spawns the ranks (`torch.multiprocessing.spawn`, at most 8,
one intra-op thread each); they meet through a `file://` rendezvous under
`tmp_path`, so no fixed port is taken, and each run has a time limit of its
own. Rank results come back as `torch.save` files.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 150

_HEADER = '''
import os, sys, torch, torch.distributed as dist, torch.multiprocessing as mp

def _rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = run(rank, world, tmp)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
'''

_FOOTER = '''
if __name__ == "__main__":
    world, tmp = int(sys.argv[1]), sys.argv[2]
    mp.spawn(_rank_main, args=(world, tmp), nprocs=world, join=True)
'''


def spawn_ranks(tmp_path: pathlib.Path, body: str, world: int = 8,
                timeout: int = RANK_TIMEOUT_S) -> list:
    """Run `body` (which defines run(rank, world, tmp)) on `world` gloo
    ranks; returns each rank's result."""
    script = tmp_path / "ranks.py"
    script.write_text(_HEADER + textwrap.dedent(body) + _FOOTER)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(world), str(tmp_path)],
                          capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, f"ranks failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-6000:]}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


STEPS = 4

_REFERENCE = f'''
import jax, numpy as np
from repro import optim
from repro.configs import get_config
from repro.core import MethodConfig
from repro.engine import FusedExecutor
from repro.models import build_model, synth_batch
from repro.runtime import make_sized_mesh
from repro.utils.trees import tree_map_with_path

cfg = get_config(ARCH, reduced=True)
bundle = build_model(cfg)
params = bundle.init(jax.random.PRNGKey(0))
batches = [synth_batch(cfg, 8, 16, jax.random.PRNGKey(i), 0.5) for i in range({STEPS})]
out = {{}}
tree_map_with_path(lambda p, x: out.__setitem__("init/" + p, np.asarray(x)), params)
for i, b in enumerate(batches):
    tree_map_with_path(lambda p, x: out.__setitem__(f"batch{{i}}/" + p, np.asarray(x)), b)
mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5, n_microbatches=N_MICRO)
ex = FusedExecutor(bundle.loss_fn, mcfg, optim.sgd(1e-2, momentum=0.9),
                   mesh=make_sized_mesh(8, 2), model_cfg=cfg)
state = ex.init_state(params, jax.random.PRNGKey(1))
losses, aux = [], []
for b in batches:
    state, m = ex.step(state, b)
    losses.append(float(m["loss"]))
    aux.append(float(m["moe_aux"]))
out["losses"], out["moe_aux"] = np.asarray(losses), np.asarray(aux)
tree_map_with_path(lambda p, x: out.__setitem__("final/" + p, np.asarray(x)),
                   jax.device_get(state.params))
np.savez(OUT, **out)
print("REFERENCE_OK")
'''

# the ranks' common part: the reference's init and batches from its npz, and
# a training run of the port on a mesh (None: one device)
_SHARDED_COMMON = '''
import numpy as np
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.engine import FusedExecutor
from repro_torch.launch.sharding import state_spec_tree
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_jax, to_reference
from repro_torch.runtime import make_sized_mesh
from repro_torch.utils import distributed


def nest(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node, parts = tree, k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def trainer(tmp):
    """train(mesh) -> (executor, state, losses, moe_aux values): the
    reference's 4 steps from its init on its batches."""
    ref = dict(np.load(f"{tmp}/reference.npz"))
    cfg = get_config(ARCH, reduced=True)
    bundle = build_model(cfg)
    sd = params_from_jax(nest(ref, "init/"))
    batches = []
    for i in range(int(ref["losses"].shape[0])):
        b = nest(ref, f"batch{i}/")
        batches.append({**{k: torch.from_numpy(v) for k, v in b.items() if k != "ascent"},
                        "ascent": {k: torch.from_numpy(v) for k, v in b["ascent"].items()}})
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5,
                        n_microbatches=N_MICRO)

    def model():
        m = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
        m.load_state_dict(sd)
        return m

    def train(mesh, prepare=lambda b: b):
        ex = FusedExecutor(bundle.loss_fn, mcfg, optim.sgd(1e-2, momentum=0.9), mesh=mesh,
                           model_cfg=cfg)
        state = ex.init_state(model(), 1)
        losses, aux = [], []
        for b in batches:
            state, m = ex.step(state, prepare(b))
            losses.append(float(m["loss"]))
            aux.append(float(m["moe_aux"]))
        return ex, state, losses, aux

    return cfg, train
'''

_SHARDED = _SHARDED_COMMON + '''

def run(rank, world, tmp):
    cfg, train = trainer(tmp)
    mesh = make_sized_mesh(8, 2)
    ex, state, losses, _ = train(mesh)
    assert not ex.resident and not ex.fused_update and ex.sharded
    # every leaf the rules shard holds 1/N of it here, N its sharded mesh dims
    specs = state_spec_tree(state, cfg, mesh)
    shares = {}
    for tree, spec_tree in ((state.params, specs.params),
                            (state.opt_state[0].momentum, specs.opt_state[0].momentum),
                            (state.method_state.ascent_grad, specs.method_state.ascent_grad)):
        for k, x in tree.items():
            n = 1
            for entry in spec_tree[k]:
                for axis in ((entry,) if isinstance(entry, str) else entry or ()):
                    n *= mesh.shape[axis]
            assert distributed.is_dtensor(x), k
            assert x.to_local().numel() * n == x.numel(), (k, spec_tree[k])
            shares[k] = n
    full = {k: distributed.gather(v) for k, v in state.params.items()}
    _, plain, plain_losses, _ = train(None)    # one device: fused and resident
    return {"losses": losses, "plain_losses": plain_losses, "shares": shares,
            "params": to_reference(full, leaf=lambda t: t.numpy()),
            "plain": to_reference(plain.params.to_tree(), leaf=lambda t: t.detach().numpy())}
'''


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        p = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, p) if isinstance(v, (dict, list)) else {p: v})
    return out


def reference_run(tmp_path, subprocess_py, arch: str, n_micro: int = 1) -> dict:
    """The reference's 4 steps of `arch` (reduced) on make_sized_mesh(8, 2),
    with its init and batches, as `tmp_path/reference.npz`."""
    out = subprocess_py(f"OUT = {str(tmp_path / 'reference.npz')!r}\nARCH = {arch!r}\n"
                        f"N_MICRO = {n_micro}\n" + _REFERENCE, devices=8,
                        timeout=RANK_TIMEOUT_S)
    assert "REFERENCE_OK" in out
    return dict(np.load(tmp_path / "reference.npz"))


def test_sharded_async_sam_matches_unsharded_and_the_reference(tmp_path, subprocess_py):
    """4 SGD-momentum AsyncSAM steps of reduced olmo-1b (batch 8 x 16, ascent
    0.5) on make_sized_mesh(8, 2): the sharded state stored 1/N on every
    rank; the same losses on every rank; against the port's unsharded run
    at the reference's own bound (max|dp| < 5e-4, |dloss| < 1e-3,
    tests/test_sharding_dryrun.py) and against the reference's sharded run at
    rtol 2e-5, atol 1e-6."""
    ref = reference_run(tmp_path, subprocess_py, "olmo-1b")
    ranks = spawn_ranks(tmp_path, 'ARCH = "olmo-1b"\nN_MICRO = 1\n' + _SHARDED)
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["losses"] == r0["losses"]
        assert r["shares"] == r0["shares"]
    # the rules shard every matmul and embedding leaf of reduced olmo 8 ways
    assert set(r0["shares"].values()) == {8}, r0["shares"]
    got, plain = _flat(r0["params"]), _flat(r0["plain"])
    want = {k[len("final/"):]: v for k, v in ref.items() if k.startswith("final/")}
    assert got.keys() == plain.keys() == want.keys()
    err = max(float(np.max(np.abs(got[k] - plain[k]))) for k in got)
    assert err < 5e-4, err
    assert max(abs(a - b) for a, b in zip(r0["losses"], r0["plain_losses"])) < 1e-3
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-5, atol=1e-6)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)


_SHARDED_MOE = _SHARDED_COMMON + '''

def run(rank, world, tmp):
    cfg, train = trainer(tmp)
    mesh = make_sized_mesh(8, 2)
    _, state, losses, aux = train(mesh)
    full = {k: distributed.gather(v) for k, v in state.params.items()}
    # the fault the dp context repairs: each rank's aux from its own rows,
    # and the dp group's mean of those slice values
    distributed.current_dp = lambda: None
    _, sliced, sliced_losses, sliced_aux = train(mesh)
    sliced_full = {k: distributed.gather(v) for k, v in sliced.params.items()}
    return {"losses": losses, "moe_aux": aux,
            "params": to_reference(full, leaf=lambda t: t.numpy()),
            "sliced_losses": sliced_losses, "sliced_aux": sliced_aux,
            "sliced": to_reference(sliced_full, leaf=lambda t: t.numpy())}
'''


def _within(got, want, rtol=2e-5, atol=1e-6) -> bool:
    return bool(np.all(np.abs(np.asarray(got) - np.asarray(want))
                       <= atol + rtol * np.abs(np.asarray(want))))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_sharded_moe_aux_is_the_whole_batchs(tmp_path, subprocess_py, arch):
    """4 SGD-momentum AsyncSAM steps of a reduced MoE model on
    make_sized_mesh(8, 2) (4 dp ranks of 2 rows, 1 ascent row each): the
    loss, `moe_aux` and the parameters after the steps hold to the
    reference's sharded run at rtol 2e-5, atol 1e-6, because each rank's
    router reduces its dispatch fraction and mean probability over the dp
    group before their product. A run whose ranks each take their own rows'
    aux (the dp group's mean of slice values) misses that tolerance, on
    `moe_aux` from the first step."""
    ref = reference_run(tmp_path, subprocess_py, arch)
    ranks = spawn_ranks(tmp_path, f"ARCH = {arch!r}\nN_MICRO = 1\n" + _SHARDED_MOE)
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["losses"] == r0["losses"] and r["moe_aux"] == r0["moe_aux"]
    assert min(r0["moe_aux"]) > 0
    got, sliced = _flat(r0["params"]), _flat(r0["sliced"])
    want = {k[len("final/"):]: v for k, v in ref.items() if k.startswith("final/")}
    assert got.keys() == want.keys()
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(r0["moe_aux"], ref["moe_aux"], rtol=2e-5, atol=1e-6)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)
    assert not _within(r0["sliced_aux"][0], ref["moe_aux"][0])
    assert not _within(r0["sliced_losses"], ref["losses"])
    assert not all(_within(sliced[k], want[k]) for k in want)


_SHARDED_MICRO = _SHARDED_COMMON + '''
from repro_torch.launch.sharding import batch_spec_tree, to_placements


def placed(batch):
    """The batch placed by batch_spec_tree (rows over "data")."""
    pl = to_placements(batch_spec_tree(batch, MESH), MESH)
    return {k: placed(v) if isinstance(v, dict)
            else distributed.place(v, MESH.device_mesh, pl[k]) for k, v in batch.items()}


def rank_rows_chunk(x, i, n):
    """The chunking this test shows wrong: chunk i of each rank's own rows
    (the placed batch's local shard), which is not the global chunk i."""
    if distributed.is_dtensor(x) and any(p.is_shard(0) for p in x.placements) \\
            and x.to_local().shape[0] % n == 0:
        from torch.distributed.tensor import DTensor
        loc = x.to_local()
        m = loc.shape[0] // n
        return DTensor.from_local(loc[i * m:(i + 1) * m], x.device_mesh, x.placements,
                                  run_check=False)
    b = x.shape[0]
    return x[i * (b // n):(i + 1) * (b // n)]


def run(rank, world, tmp):
    global MESH
    cfg, train = trainer(tmp)
    MESH = make_sized_mesh(8, 2)
    _, state, losses, aux = train(MESH, placed)
    full = {k: distributed.gather(v) for k, v in state.params.items()}
    distributed.row_chunk = rank_rows_chunk
    _, _, own_losses, own_aux = train(MESH, placed)
    return {"losses": losses, "moe_aux": aux,
            "params": to_reference(full, leaf=lambda t: t.numpy()),
            "own_losses": own_losses, "own_aux": own_aux}
'''


def test_placed_batch_microbatches_are_the_global_chunks(tmp_path, subprocess_py):
    """4 SGD-momentum AsyncSAM steps of reduced mixtral-8x7b on
    make_sized_mesh(8, 2) with 2 microbatches, the batch placed by
    `batch_spec_tree` (2 rows a dp rank, the 4 ascent rows 1 a rank):
    microbatch i is the batch's global rows [4 i, 4 i + 4), as the
    reference chunks it, so the MoE aux of each microbatch (a whole-chunk
    value) and the loss and parameters hold to the reference's sharded run
    at rtol 2e-5, atol 1e-6. Chunk i of each rank's own rows (the chunking
    before this repair) misses that tolerance on `moe_aux`."""
    ref = reference_run(tmp_path, subprocess_py, "mixtral-8x7b", n_micro=2)
    ranks = spawn_ranks(tmp_path, 'ARCH = "mixtral-8x7b"\nN_MICRO = 2\n' + _SHARDED_MICRO)
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["losses"] == r0["losses"] and r["moe_aux"] == r0["moe_aux"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(r0["moe_aux"], ref["moe_aux"], rtol=2e-5, atol=1e-6)
    got = _flat(r0["params"])
    want = {k[len("final/"):]: v for k, v in ref.items() if k.startswith("final/")}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)
    assert not _within(r0["own_aux"], ref["moe_aux"])


_RESHARD = '''
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig, init_train_state, make_method
from repro_torch.models import build_model
from repro_torch.runtime import make_sized_mesh, reshard_state
from repro_torch.utils import distributed


def tensors(tree):
    """Every tensor of a state, in order (host values left out)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tensors(t)]
    return []


def clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(clone, tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(clone, tree))
    return tree


def run(rank, world, tmp):
    cfg = get_config("olmo-1b", reduced=True)
    bundle = build_model(cfg)
    method = make_method(MethodConfig(name="async_sam", fused_update=False))
    state = init_train_state(bundle.init(0, "cpu"), optim.adamw(1e-3), method, 1,
                             resident=False)
    # a carried ascent gradient that is not zeros, and host values that move
    for t in state.method_state.ascent_grad.values():
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(t.numel())))
    state = state._replace(step=7, method_state=state.method_state._replace(
        have_ascent=True, staleness=1))
    orig = clone(state)
    mesh_a, mesh_b = make_sized_mesh(8, 2), make_sized_mesh(8, 4)
    on_a = reshard_state(state, cfg, mesh_a)
    on_b = reshard_state(on_a, cfg, mesh_b)
    shares_a = sorted({x.to_local().numel() / x.numel() for x in on_a.params.values()})
    shares_b = sorted({x.to_local().numel() / x.numel() for x in on_b.params.values()})
    back = reshard_state(on_b, cfg, None)
    # a shrink to 4 ranks and a grow back: ranks 4-7 hold nothing between
    on_c = reshard_state(on_a, cfg, make_sized_mesh(4, 2))
    empty_c = all(x.to_local().numel() == 0 for x in on_c.params.values())
    regrown = reshard_state(reshard_state(on_c, cfg, mesh_a), cfg, None)

    def same(a, b):
        xs, ys = tensors(a), tensors(b)
        return len(xs) == len(ys) > 0 and all(
            not distributed.is_dtensor(x) and torch.equal(x, y) for x, y in zip(xs, ys))

    return {"roundtrip": same(back, orig), "regrown": same(regrown, orig),
            "host": (back.step, back.method_state.have_ascent, back.method_state.staleness,
                     regrown.step),
            "shares": (shares_a, shares_b), "empty_c": empty_c,
            "dtensor": all(map(distributed.is_dtensor, on_a.params.values()))}
'''


def test_reshard_roundtrip_is_bit_for_bit(tmp_path):
    """AdamW AsyncSAM state (params, both moments, the carried ascent
    gradient, the scalars and host values) (4, 2) -> (2, 4) -> whole, and
    (4, 2) -> 4 ranks -> (4, 2) -> whole: the same bits
    (tests/test_runtime.py's round trip)."""
    ranks = spawn_ranks(tmp_path, _RESHARD)
    for rank, r in enumerate(ranks):
        assert r["roundtrip"] and r["regrown"], rank
        assert r["host"] == (7, True, 1, 7)
        assert r["dtensor"]
        assert r["shares"] == ([0.125], [0.125])
        assert r["empty_c"] == (rank >= 4)
