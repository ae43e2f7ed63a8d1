"""The reference's "fsdp_sp" profile in the port (`models.partitioning`):
each rank of the model group computes its block of the sequence on whole
weights, on a world of CPU ranks (gloo).

Both sides take reduced qwen2.5-32b (dense, GQA 5/1, QKV bias) and reduced
zamba2-1.2b (mamba2 blocks and the shared attention block with its LoRA)
with `sharding_profile="fsdp_sp"` (the reduced configs keep "tp"). One
reference subprocess (8 fake CPU devices, `tests/conftest.py:run_py`) runs
the reference's 4 sharded AsyncSAM steps on `make_sized_mesh(8, 4)` (data 2
x model 4: 8 positions a rank of 32, one zamba2 chunk, three links of the
SSD state chain) and its meshless prefill and decode; one spawn of 8 gloo
ranks (`test_torch_distributed.spawn_ranks`) runs the port's on the same
init and batches, with probes on the flash and SSD wrappers and on the
weight gathers, and the loss and halo checks. The flash kernel's plain
version with a query offset, the visible-pair count and the pure SSD state
prefix are held in this process.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import run_py
from test_torch_distributed import RANK_TIMEOUT_S, _flat, spawn_ranks

ARCHS = ("qwen2.5-32b", "zamba2-1.2b")
STEPS, SEQ, PROMPT, N_DEC, M = 4, 32, 16, 4, 4
# sequences every rank computes whole: 30, which 4 does not divide, and
# zamba2's 8, whose blocks of 2 are shorter than the conv's halo of 3
WHOLE, WHOLE_STEPS = {"qwen2.5-32b": 30, "zamba2-1.2b": 8}, 2

_REFERENCE = f'''
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro import optim
from repro.configs import get_config
from repro.core import MethodConfig
from repro.engine import FusedExecutor
from repro.models import build_model, synth_batch
from repro.runtime import make_sized_mesh
from repro.utils.trees import tree_map_with_path

for arch in ARCHS:
    cfg = dataclasses.replace(get_config(arch, reduced=True), sharding_profile="fsdp_sp")
    bundle = build_model(cfg)
    params = bundle.init(jax.random.PRNGKey(0))
    batches = [synth_batch(cfg, 8, {SEQ}, jax.random.PRNGKey(i), 0.5) for i in range({STEPS})]
    out = {{}}
    tree_map_with_path(lambda p, x: out.__setitem__("init/" + p, np.asarray(x)), params)
    for i, b in enumerate(batches):
        tree_map_with_path(lambda p, x: out.__setitem__(f"batch{{i}}/" + p, np.asarray(x)), b)
    # meshless serving: a prompt of 8 rows, then {N_DEC} given tokens a row
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (8, {PROMPT})).astype(np.int32)
    fed = rng.integers(0, cfg.vocab_size, ({N_DEC}, 8, 1)).astype(np.int32)
    logits, cache = jax.jit(lambda p, b: bundle.prefill(p, b, pad_to={PROMPT + N_DEC}))(
        params, {{"tokens": jnp.asarray(prompt)}})
    served = [np.asarray(logits)]
    decode = jax.jit(bundle.decode)
    for t in range({N_DEC}):
        logits, cache = decode(params, cache, {{"tokens": jnp.asarray(fed[t])}})
        served.append(np.asarray(logits))
    out["prompt"], out["fed"], out["served"] = prompt, fed, np.stack(served)
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)
    ex = FusedExecutor(bundle.loss_fn, mcfg, optim.sgd(1e-2, momentum=0.9),
                       mesh=make_sized_mesh(8, {M}), model_cfg=cfg)
    state = ex.init_state(params, jax.random.PRNGKey(1))
    losses = []
    for b in batches:
        state, m = ex.step(state, b)
        losses.append(float(m["loss"]))
    out["losses"] = np.asarray(losses)
    tree_map_with_path(lambda p, x: out.__setitem__("final/" + p, np.asarray(x)),
                       jax.device_get(state.params))
    # a sequence left whole on every rank of the model group
    wb = [synth_batch(cfg, 8, WHOLE[arch], jax.random.PRNGKey(10 + i), 0.5)
          for i in range({WHOLE_STEPS})]
    for i, b in enumerate(wb):
        tree_map_with_path(lambda p, x: out.__setitem__(f"whole{{i}}/" + p, np.asarray(x)), b)
    state, losses = ex.init_state(params, jax.random.PRNGKey(1)), []
    for b in wb:
        state, m = ex.step(state, b)
        losses.append(float(m["loss"]))
    out["whole_losses"] = np.asarray(losses)
    tree_map_with_path(lambda p, x: out.__setitem__("whole_final/" + p, np.asarray(x)),
                       jax.device_get(state.params))
    np.savez(f"{{OUT}}/{{arch}}.npz", **out)
print("REFERENCE_OK")
'''

_RANKS = f'''
import dataclasses
import numpy as np
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.engine import FusedExecutor
from repro_torch.kernels import ops
from repro_torch.launch.sharding import batch_spec_tree, state_spec_tree, to_placements
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model, registry, ssm, transformer
from repro_torch.models.convert import params_from_jax, to_reference
from repro_torch.models.partitioning import activation_sharding, current_layout
from repro_torch.runtime import make_sized_mesh
from repro_torch.utils import distributed


def nest(flat, prefix):
    tree = {{}}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node, parts = tree, k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {{}})
        node[parts[-1]] = v
    return tree


# what the wrappers and the weight gathers see on this rank
SEEN = {{"flash": set(), "mix": set(), "gather": set()}}
_flash, _mix, _gather = ops.flash_attention, ops.mamba2_mix, distributed.gather_for_compute


def flash(q, k, v, *args, q_offset=0, **kwargs):
    SEEN["flash"].add((q.shape[1], q_offset, k.shape[1]))
    return _flash(q, k, v, *args, q_offset=q_offset, **kwargs)


def mix(x, *args, init_state=None, **kwargs):
    SEEN["mix"].add((x.shape[1], init_state is not None))
    return _mix(x, *args, init_state=init_state, **kwargs)


def gather(x, group=None, n=1, keep=None):
    flat, _ = distributed.mesh_groups(x.device_mesh)
    SEEN["gather"].add((group is flat, n, keep))
    return _gather(x, group, n, keep)


ops.flash_attention, ops.mamba2_mix = flash, mix


def one_arch(arch, tmp, mesh):
    ref = dict(np.load(f"{{tmp}}/{{arch}}.npz"))
    cfg = dataclasses.replace(get_config(arch, reduced=True), sharding_profile="fsdp_sp")
    sd = params_from_jax(nest(ref, "init/"))

    def batches_of(prefix, n):
        out = []
        for i in range(n):
            b = nest(ref, f"{{prefix}}{{i}}/")
            out.append({{**{{k: torch.from_numpy(v) for k, v in b.items() if k != "ascent"}},
                        "ascent": {{k: torch.from_numpy(v) for k, v in b["ascent"].items()}}}})
        return out

    batches = batches_of("batch", int(ref["losses"].shape[0]))
    whole_batches = batches_of("whole", int(ref["whole_losses"].shape[0]))
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)

    def model():
        m = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
        m.load_state_dict(sd)
        return m

    def train(c, steps, data=batches):
        ex = FusedExecutor(build_model(c).loss_fn, mcfg, optim.sgd(1e-2, momentum=0.9),
                           mesh=mesh, model_cfg=c)
        state, losses = ex.init_state(model(), 1), []
        for b in data[:steps]:
            state, m = ex.step(state, b)
            losses.append(float(m["loss"]))
        return state, losses

    for seen in SEEN.values():
        seen.clear()
    distributed.gather_for_compute = gather
    state, losses = train(cfg, len(batches))
    distributed.gather_for_compute = _gather
    full = {{k: distributed.gather(v) for k, v in state.params.items()}}
    probes = {{k: sorted(v, key=str) for k, v in SEEN.items()}}
    # remat "full": the blocks' gathers and exchanges run again in backward
    _, remat_losses = train(dataclasses.replace(cfg, remat="full"), 2)
    # a sequence left whole on every rank
    for seen in SEEN.values():
        seen.clear()
    distributed.gather_for_compute = gather
    wstate, whole_losses = train(cfg, len(whole_batches), whole_batches)
    distributed.gather_for_compute = _gather
    whole_run = {{"losses": whole_losses, "probes": {{k: sorted(v, key=str) for k, v in SEEN.items()}},
              "params": to_reference({{k: distributed.gather(v) for k, v in wstate.params.items()}},
                                     leaf=lambda t: t.numpy())}}

    # (c) prefill and decode on placed params and batch
    bundle = build_model(cfg)
    whole = model()
    named = dict(whole.named_parameters())
    pl = to_placements(state_spec_tree(named, cfg, mesh), mesh)
    placed = {{k: distributed.place(v.detach(), mesh.device_mesh, pl[k])
              for k, v in named.items()}}

    def batch_of(tokens):
        t = torch.from_numpy(tokens)
        return {{"tokens": distributed.place(t, mesh.device_mesh,
                                            to_placements(batch_spec_tree({{"tokens": t}}, mesh),
                                                          mesh)["tokens"])}}

    served = []
    SEEN["flash"].clear()
    with torch.no_grad():
        pad = ref["prompt"].shape[1] + len(ref["fed"])
        logits, cache = make_prefill_step(bundle, mesh, pad)(placed, batch_of(ref["prompt"]))
        served.append(logits.numpy())
        decode = make_decode_step(bundle, mesh)
        for fed in ref["fed"]:
            logits, cache = decode(placed, cache, batch_of(fed))
            served.append(logits.numpy())
    k = (cache["shared"] if "shared" in cache else cache["layers"])["k"]
    return {{"losses": losses, "remat_losses": remat_losses, "whole": whole_run,
            "params": to_reference(full, leaf=lambda t: t.numpy()),
            "probes": probes, "serve_flash": sorted(SEEN["flash"]), "served": served,
            "cache_k": (tuple(k.shape), tuple(k.to_local().shape), str(k.placements)),
            "rows": distributed.dp_index(mesh.device_mesh, [0])}}


def loss_and_halo(mesh):
    """(f) the loss over blocks with unequal label counts, (g) the halo conv,
    both against the whole sequence's, in float64."""
    torch.manual_seed(0)
    cfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True),
                              sharding_profile="fsdp_sp", compute_dtype="float64")
    b, s, v, c, w = 2, {SEQ}, cfg.vocab_size, 6, cfg.ssm.d_conv
    logits = torch.randn(b, s, v, dtype=torch.float64) * 3
    labels = torch.randint(0, v, (b, s))
    labels[:, -5:] = -1                      # the last block holds fewer labels
    labels[0, 3] = -1
    xin = torch.randn(b, s, c, dtype=torch.float64)
    cw, cb = torch.randn(w, c, dtype=torch.float64), torch.randn(c, dtype=torch.float64)
    gy = torch.randn(b, s, c, dtype=torch.float64)
    lw = logits.clone().requires_grad_()
    plain = registry.cross_entropy(lw, labels)
    plain.backward()
    xw = xin.clone().requires_grad_()
    y_whole, _ = ssm._causal_conv(xw, cw, cb)
    (y_whole * gy).sum().backward()
    with activation_sharding(mesh):
        lay = current_layout()
        lo, hi = lay.shard_range(s)
        lb = logits[:, lo:hi].clone().requires_grad_()
        ce = registry.sequence_parallel_cross_entropy(lb, labels[:, lo:hi], cfg)
        ce.backward()
        mine = registry.cross_entropy(logits[:, lo:hi], labels[:, lo:hi])
        means = [torch.empty(()) for _ in range(lay.m)]
        dist.all_gather(means, mine.float().reshape(()), group=lay.model_group)
        xb = xin[:, lo:hi].clone().requires_grad_()
        halo = distributed.halo_from_prev(xb, w - 1, lay)
        y_blk, tail = ssm._causal_conv(xb, cw, cb, halo)
        (y_blk * gy[:, lo:hi]).sum().backward()
    return {{"ce": (float(ce), float(plain)), "mean_of_means": float(torch.stack(means).mean()),
            "ce_grad": float((lb.grad - lw.grad[:, lo:hi]).abs().max()),
            "conv": float((y_blk - y_whole[:, lo:hi]).abs().max()),
            "tail": float((tail - xin[:, hi - w + 1:hi]).abs().max()),
            "conv_grad": float((xb.grad - xw.grad[:, lo:hi]).abs().max())}}


def mesa(cfg, mesh):
    """MESA reads aux["logits"] whole: 3 steps (the term on from step 1)
    sharded and meshless on the same init and batches."""
    from repro_torch.models import synth_batch
    from repro_torch.engine.fused import _dp_loss
    from repro_torch.models import synth_batch
    mcfg = MethodConfig(name="mesa", mesa_start_step=1)
    batches = [synth_batch(cfg, 4, {SEQ}, i, device="cpu") for i in range(3)]
    out = {{}}
    for name, m in (("sharded", mesh), ("meshless", None)):
        ex = FusedExecutor(build_model(cfg).loss_fn, mcfg, optim.sgd(1e-2, momentum=0.9),
                           mesh=m, model_cfg=cfg if m is not None else None)
        state, metrics = ex.init_state(transformer.init_params(cfg, seed=0, device="cpu"), 1), []
        for b in batches:
            state, mt = ex.step(state, b)
            metrics.append((float(mt["loss"]), float(mt["mesa_kl"])))
        out[name] = (metrics, {{k: distributed.gather(v).clone() for k, v in state.params.items()}})
        if m is not None:
            sharded = state.params
    # the logits MESA reads on a rank: its dp rows and sequence block
    with torch.no_grad():
        _, aux = _dp_loss(build_model(cfg).loss_fn, mesh, cfg.vocab_size)(
            sharded, batches[0], None)
    out["logits_shape"] = tuple(aux["logits"].shape)
    return out


def run(rank, world, tmp):
    mesh = make_sized_mesh(8, {M})
    sp = dataclasses.replace(get_config("qwen2.5-32b", reduced=True), sharding_profile="fsdp_sp")
    return {{**{{arch: one_arch(arch, tmp, mesh) for arch in ARCHS}}, "fg": loss_and_halo(mesh),
            "mesa": {{"fsdp_sp": mesa(sp, mesh),
                     "tp": mesa(get_config("olmo-1b", reduced=True), make_sized_mesh(8, 2))}}}}
'''


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """The reference's runs and the port's 8 ranks' results, by arch."""
    tmp = tmp_path_factory.mktemp("sp")
    # each side runs 3 shapes of 2 archs' sharded step, and the suite's
    # other workers share the cores: run_py's default time, 3 ranks' times
    out = run_py(f"OUT = {str(tmp)!r}\nARCHS = {ARCHS!r}\nWHOLE = {WHOLE!r}\n" + _REFERENCE,
                 devices=8)
    assert "REFERENCE_OK" in out
    refs = {a: dict(np.load(tmp / f"{a}.npz")) for a in ARCHS}
    ranks = spawn_ranks(tmp, f"ARCHS = {ARCHS!r}\n" + _RANKS, timeout=3 * RANK_TIMEOUT_S)
    return refs, ranks


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_async_sam_matches_the_reference(sp_runs, arch):
    """(a) 4 SGD-momentum AsyncSAM steps on make_sized_mesh(8, 4) with the
    "fsdp_sp" profile, each rank of the 4-way model group on its 8 of 32
    positions: the losses on every rank, and every parameter after the
    steps, hold to the reference's sharded run at rtol 2e-5, atol 1e-6;
    with remat "full" (each block's weight gathers, k/v gathers, halos and
    state exchanges run again in its recompute, in one order on every rank)
    the first 2 steps' losses are the same at 1e-6."""
    refs, ranks = sp_runs
    ref, r0 = refs[arch], ranks[0][arch]
    for r in ranks[1:]:
        assert r[arch]["losses"] == r0["losses"]
    np.testing.assert_allclose(r0["remat_losses"], r0["losses"][:2], rtol=1e-6)
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-5, atol=1e-6)
    got = _flat(r0["params"])
    want = {k[len("final/"):]: v for k, v in ref.items() if k.startswith("final/")}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_probe_blocks_offsets_and_summed_gradients(sp_runs, arch):
    """(b) The same run's probes on each rank r (its index along "model",
    the mesh's second coordinate): every flash call saw 8 queries at
    q_offset 8 r against all 32 keys; zamba2's SSD wrapper saw 8 positions,
    once from no state and once from the chained one; every weight was
    gathered whole with its gradient reduced over the flattened mesh and
    divided by the 2 dp ranks (summed over "model")."""
    _, ranks = sp_runs
    blk = SEQ // M
    for world_rank, r in enumerate(ranks):
        a = r[arch]["probes"]
        idx = world_rank % M
        assert a["flash"] == [(blk, blk * idx, SEQ)], a["flash"]
        if arch == "zamba2-1.2b":
            assert a["mix"] == [(blk, False), (blk, True)], a["mix"]
        assert a["gather"] == [(True, 2, None)], a["gather"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_whole_sequence_matches_the_reference(sp_runs, arch):
    """A sequence the layout leaves whole on every rank (qwen2.5-32b's 30,
    which 4 does not divide; zamba2's 8, whose blocks of 2 would be shorter
    than the conv's halo of 3): 2 AsyncSAM steps on make_sized_mesh(8, 4)
    hold the losses and every parameter to the reference's sharded run at
    rtol 2e-5, atol 1e-6; each rank's flash call saw the whole sequence at
    offset 0, zamba2's SSD wrapper one pass from no state, and every weight
    was gathered with its gradient averaged over the 2 dp ranks and not
    summed over "model" (each model rank computed all of it)."""
    refs, ranks = sp_runs
    ref, s = refs[arch], WHOLE[arch]
    for r in ranks:
        w = r[arch]["whole"]
        np.testing.assert_allclose(w["losses"], ref["whole_losses"], rtol=2e-5, atol=1e-6)
        assert w["probes"]["flash"] == [(s, 0, s)], w["probes"]["flash"]
        if arch == "zamba2-1.2b":
            assert w["probes"]["mix"] == [(s, False)], w["probes"]["mix"]
        assert w["probes"]["gather"] == [(False, 2, None)], w["probes"]["gather"]
    got = _flat(ranks[0][arch]["whole"]["params"])
    want = {k[len("whole_final/"):]: v for k, v in ref.items() if k.startswith("whole_final/")}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_prefill_decode_match_the_reference(sp_runs, arch):
    """(c) Prefill of 8 prompts of 16 and 4 decode steps on given tokens
    (cache 20: 5 positions a rank, blocks that the prompt's 4 a rank do not
    align with), params and batch placed over make_sized_mesh(8, 4): each
    rank's rows of the logits match the reference's meshless run at 2e-5
    of their scale; prefill's flash calls saw 4 queries at offset 4 r
    against 16 keys; the k cache keeps its sequence over "model"."""
    refs, ranks = sp_runs
    ref = refs[arch]
    for world_rank, r in enumerate(ranks):
        a = r[arch]
        idx, n = a["rows"]
        rows = slice(idx * 8 // n, (idx + 1) * 8 // n)
        for step, got in enumerate(a["served"]):
            want = ref["served"][step]
            scale = float(np.abs(want).max())
            assert np.abs(got - want[rows]).max() <= 2e-5 * scale, (arch, step)
        p = PROMPT // M
        assert a["serve_flash"] == [(p, p * (world_rank % M), PROMPT)], a["serve_flash"]
        shape, local, placements = a["cache_k"]
        assert placements == "(Shard(dim=1), Shard(dim=2))", placements
        assert local[2] * M == shape[2] == PROMPT + N_DEC and local[1] * 2 == shape[1]


def test_sp_loss_is_the_global_mean(sp_runs):
    """(f) Over 4 blocks of 2 x 8 positions with 15, 16, 16 and 6 labels
    (the last holds the -1 labels), the sequence-parallel loss and its
    gradient equal the whole sequence's masked mean on every rank at 1e-6
    (both compute in fp32, summed in another order); the mean of the
    blocks' means misses it by more than 2e-5."""
    _, ranks = sp_runs
    for r in ranks:
        got, want = r["fg"]["ce"]
        assert abs(got - want) <= 1e-6 * abs(want) and r["fg"]["ce_grad"] <= 1e-6, r["fg"]
        assert abs(r["fg"]["mean_of_means"] - want) > 2e-5 * abs(want), r["fg"]


def test_sp_halo_conv_is_the_whole_conv(sp_runs):
    """(g) Each rank's causal conv over its block with the previous block's
    last d_conv - 1 rows (`distributed.halo_from_prev`, zeros on rank 0)
    equals its rows of the whole sequence's conv, its tail is the block's
    last inputs, and the inputs' gradient (the halo's sent back to the
    previous rank) equals the whole conv's, in float64 at 1e-12."""
    _, ranks = sp_runs
    for r in ranks:
        fg = r["fg"]
        assert fg["conv"] <= 1e-12 and fg["tail"] == 0.0 and fg["conv_grad"] <= 1e-12, fg


@pytest.mark.parametrize("profile", ["fsdp_sp", "tp"])
def test_sharded_mesa_reads_the_whole_batchs_logits(sp_runs, profile):
    """P3: MESA's KL term is the whole batch's mean over positions that the
    sharded loss leaves on their ranks: aux["logits"] gathered over the
    vocabulary only, aux["position_mean"] reduced over the dp rows and the
    sequence blocks (`engine.fused._dp_loss`, `distributed.global_mean`).
    3 steps of reduced qwen2.5-32b with "fsdp_sp" on make_sized_mesh(8, 4)
    and of reduced olmo-1b ("tp") on make_sized_mesh(8, 2), with 2 or 4 dp
    ranks, equal the meshless port's: the loss and the KL at 1e-5 (each dp
    rank's KL of its own rows missed by 5e-4), every parameter at 2e-5 of
    its max; the logits MESA reads are the rank's 4 / n rows, of its block
    of the sequence, over all 256 entries of the vocabulary."""
    _, ranks = sp_runs
    shape = {"fsdp_sp": (4 // 2, SEQ // M, 256), "tp": (4 // 4, SEQ, 256)}[profile]
    for r in ranks:
        assert r["mesa"][profile]["logits_shape"] == shape, r["mesa"][profile]["logits_shape"]
        (got, gp), (want, wp) = r["mesa"][profile]["sharded"], r["mesa"][profile]["meshless"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        for k in wp:
            assert (gp[k] - wp[k]).abs().max() <= 2e-5 * wp[k].abs().max(), k


# ---------------------------------------------------------------------------
# (d) the flash kernel's plain version with a query offset
# ---------------------------------------------------------------------------

def _qkv(b, sq, sk, h, kv, hd, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)).to(dtype)
            for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


@pytest.mark.parametrize("sk,window", [(512, None), (512, 100), (96, None), (96, 17)])
@pytest.mark.parametrize("q0", [0, 40, 64])
def test_flash_plain_with_offset_is_the_whole_calls_rows(sk, window, q0):
    """(d) The plain flash (GQA 4/2, the blocked path at 512 keys and
    `mha_reference`'s at 96) of rows [q0, q0 + 32) with q_offset q0 equals
    those rows of the whole causal call, with and without a window, in
    float64 at 1e-12."""
    from repro_torch.kernels import ref
    q, k, v = _qkv(2, sk, sk, 4, 2, 16)
    whole = ref.flash_attention_plain(q, k, v, causal=True, window=window)
    part = ref.flash_attention_plain(q[:, q0:q0 + 32], k, v, causal=True, window=window,
                                     q_offset=q0)
    assert (part - whole[:, q0:q0 + 32]).abs().max() <= 1e-12


@pytest.mark.parametrize("window", [None, 9])
def test_flash_plain_with_offset_matches_the_reference_oracle(window):
    """(d) The plain flash with q_offset 24 (the blocked path, 512 keys)
    against `repro.kernels.ref.mha_reference` with the same offset, in
    float32 at 2e-5; and the wrapper's CPU path is the plain version."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v = _qkv(1, 512, 512, 4, 2, 16, seed=1, dtype=torch.float32)
    q = q[:, 100:140]
    got = ref.flash_attention_plain(q, k, v, causal=True, window=window, q_offset=100)
    want = np.asarray(jref.mha_reference(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                         jnp.asarray(v.numpy()), causal=True, window=window,
                                         q_offset=100))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert torch.equal(fa.flash_attention(q, k, v, window=window, q_offset=100), got)


def _pairs_by_loop(sq, sk, causal, window, q0):
    total = 0
    for i in range(sq):
        p = q0 + i
        hi = min(sk, p + 1) if causal else sk
        lo = max(0, p - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


@pytest.mark.parametrize("q0", [0, 5, 256, 3840])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, None),
                                           (False, 64)])
def test_visible_pairs_with_offset(q0, causal, window):
    """The flop formula's pair count with a query offset (a rank's block of
    256 queries against 4096 keys) equals a loop over the rows."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.visible_pairs(256, 4096, causal, window, q0) == \
        _pairs_by_loop(256, 4096, causal, window, q0)


# ---------------------------------------------------------------------------
# (e) the SSD scan chained over blocks by the pure state prefix
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, h, p, n, g, seed, dtype):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)

    dt = torch.nn.functional.softplus(t(b, s, h) - 2.0)
    a = -torch.exp(t(h, scale=0.5))
    return t(b, s, h, p), dt, a, t(b, s, g, n), t(b, s, g, n), t(h)


def _chained(x, dt, a, b, c, d, blocks, chunk):
    """The scan cut into `blocks` along the sequence: pass 1 per block from
    no state, the prefix over the stacked finals and log decays, pass 2."""
    from repro_torch.kernels import ref
    from repro_torch.utils import distributed
    cut = [slice(i * x.shape[1] // blocks, (i + 1) * x.shape[1] // blocks) for i in range(blocks)]
    finals, decays = [], []
    for sl in cut:
        _, s_r = ref.mamba2_chunked_plain(x[:, sl], dt[:, sl], a, b[:, sl], c[:, sl], d,
                                          chunk=chunk)
        finals.append(s_r)
        decays.append(a * dt[:, sl].sum(dim=1))
    s_all, l_all = torch.stack(finals), torch.stack(decays)
    ys, last = [], None
    for r, sl in enumerate(cut):
        h = distributed.state_prefix(s_all, l_all, r)
        y, last = ref.mamba2_chunked_plain(x[:, sl], dt[:, sl], a, b[:, sl], c[:, sl], d,
                                           chunk=chunk, init_state=h)
        ys.append(y)
    return torch.cat(ys, dim=1), last


def test_chained_scan_equals_the_whole_scan_and_the_reference():
    """(e) 4 blocks of 16 positions (chunk 8): y and the final state of the
    chained scan equal one whole `mamba2_chunked_plain` call and the
    reference's `mamba2_chunked_jnp` at 2e-5, in float32."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    args = _ssd_inputs(2, 64, 4, 8, 16, 1, seed=3, dtype=torch.float32)
    y, st = _chained(*args, blocks=4, chunk=8)
    y_w, st_w = ref.mamba2_chunked_plain(*args, chunk=8)
    y_j, st_j = jref.mamba2_chunked_jnp(*(jnp.asarray(t.numpy()) for t in args), chunk=8)
    for got, want in ((y, y_w), (st, st_w), (y, np.asarray(y_j)), (st, np.asarray(st_j))):
        want = torch.as_tensor(np.array(want))
        tol = 2e-5 * float(want.abs().max())
        assert (got - want).abs().max() <= tol


def test_chained_scan_gradients_equal_the_whole_scans():
    """(e) In float64, the gradients of a loss of the chained scan's y and
    final state by autograd, through both passes and the prefix, equal
    those of the whole call at 1e-10 of their scale: x, dt, a, b, c, d."""
    from repro_torch.kernels import ref
    args = [t.requires_grad_() for t in _ssd_inputs(2, 32, 4, 4, 8, 2, seed=4,
                                                    dtype=torch.float64)]
    rng = np.random.default_rng(5)
    gy = torch.from_numpy(rng.standard_normal((2, 32, 4, 4)))
    gs = torch.from_numpy(rng.standard_normal((2, 4, 4, 8)))
    y, st = _chained(*args, blocks=4, chunk=8)
    got = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), args)
    y_w, st_w = ref.mamba2_chunked_plain(*args, chunk=8)
    want = torch.autograd.grad((y_w * gy).sum() + (st_w * gs).sum(), args)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-10 * float(w.abs().max())


def test_state_prefix_reaches_every_entry():
    """The prefix of block 0 is zero and the gradient reaches every gathered
    entry on every rank (zero from block r on), so each rank's gather runs
    its backward."""
    from repro_torch.utils import distributed
    s_all = torch.randn(4, 2, 3, 2, 2, dtype=torch.float64, requires_grad=True)
    l_all = -torch.rand(4, 2, 3, dtype=torch.float64, requires_grad=True)
    for r in range(4):
        h = distributed.state_prefix(s_all, l_all, r)
        gs, gl = torch.autograd.grad(h.sum(), (s_all, l_all))
        assert gs is not None and gl is not None
        assert torch.count_nonzero(gs[r:]) == 0 and torch.count_nonzero(gl[r:]) == 0
        if r == 0:
            assert torch.count_nonzero(h) == 0
        else:
            assert torch.count_nonzero(gs[:r]) == gs[:r].numel()
