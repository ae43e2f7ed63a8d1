"""The reference's "fsdp_sp" profile for the rwkv6, moe (MLA too), vlm and
audio families in the port (`models.rwkv`, `models.moe`, `models.mla`,
`models.transformer`, `models.encdec`, `models.partitioning`): each rank of
the model group computes its block of the sequence on whole weights, on a
world of CPU ranks (gloo).

One reference subprocess (8 fake CPU devices, `tests/conftest.py:run_py`)
runs the reference's 4 sharded AsyncSAM SGD-momentum steps with
`sharding_profile="fsdp_sp"` of reduced rwkv6-7b (lr 3e-5) on
`make_sized_mesh(8, 2)` and `(8, 4)`, and 2 on a sequence of 18 that 4 does
not divide (computed whole); of reduced mixtral and deepseek on `(8, 4)`
at capacity factor 0.5, so that every row drops routes; of reduced
phi-3-vision (its image positions' labels masked: the loss reads the text)
and whisper-tiny on `(8, 2)`; and each arch's meshless prefill and decode.
Then one spawn of 8 gloo ranks (`test_torch_distributed.spawn_ranks`)
runs the port's on the same init and batches, with probes on the wkv,
flash and routing calls and two controls that must miss the reference
after mixtral's first 2 steps: MoE positions without the earlier blocks'
counts, and the aux of each rank's own block. In process: the wkv state chained over blocks by
`distributed.state_prefix` against one whole scan, the MoE block ranks
against the whole row's `assign`, and a fake-tensor trace on a (data 2,
model 2) fake mesh whose flops are counted by hand.
"""
import numpy as np
import pytest
import torch

from conftest import run_py
from test_torch_distributed import RANK_TIMEOUT_S, _flat, spawn_ranks

# (arch, model axis, sequence, steps) of each sharded training run
RUNS = (("rwkv6-7b", 2, 16, 4), ("rwkv6-7b", 4, 16, 4), ("rwkv6-7b", 4, 18, 2),
        ("mixtral-8x7b", 4, 32, 4), ("deepseek-v2-lite-16b", 4, 32, 4),
        ("phi-3-vision-4.2b", 2, 16, 4), ("whisper-tiny", 2, 16, 4))
ARCHS = ("rwkv6-7b", "mixtral-8x7b", "deepseek-v2-lite-16b", "phi-3-vision-4.2b",
         "whisper-tiny")
LR = {"rwkv6-7b": 3e-5}
CAPACITY = 0.5
PROMPT, PAD, N_DEC = 24, 32, 4
# the controls (mixtral's) run the first CONTROL_STEPS steps, held against
# the reference after as many
CONTROL_STEPS = 2


def _key(arch, model, seq):
    return f"{arch}_8x{model}_s{seq}"


# the config both sides run: "fsdp_sp", the MoE models at a capacity
# factor that drops routes
_CONFIG = f'''
import dataclasses


def sp_config(arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), sharding_profile="fsdp_sp")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor={CAPACITY}))
    return cfg
'''

_REFERENCE = f'''
import jax, jax.numpy as jnp, numpy as np
from repro import optim
from repro.configs import get_config
from repro.core import MethodConfig
from repro.engine import FusedExecutor
from repro.models import build_model, synth_batch
from repro.runtime import make_sized_mesh
from repro.utils.trees import tree_map_with_path

# the same programs compiled with less optimization: a third of the time
jax.config.update("jax_disable_most_optimizations", True)
{_CONFIG}

def batch_of(cfg, seq, i):
    b = synth_batch(cfg, 8, seq, jax.random.PRNGKey(i), 0.5)
    if cfg.vision is not None:   # the loss reads the text positions' labels
        n = cfg.vision.n_image_tokens
        b["labels"] = b["labels"].at[:, :n].set(-1)
        b["ascent"]["labels"] = b["ascent"]["labels"].at[:, :n].set(-1)
    return b


for arch in ARCHS:
    cfg = sp_config(arch)
    bundle = build_model(cfg)
    params = bundle.init(jax.random.PRNGKey(0))
    out = {{}}
    tree_map_with_path(lambda p, x: out.__setitem__("init/" + p, np.asarray(x)), params)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (8, {PROMPT})).astype(np.int32)
    fed = rng.integers(0, cfg.vocab_size, ({N_DEC}, 8, 1)).astype(np.int32)
    pre = {{"tokens": jnp.asarray(prompt)}}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((8, {PROMPT}, cfg.d_model)).astype(np.float32)
        pre["enc_frames"] = jnp.asarray(out["frames"])
    if cfg.vision is not None:
        shape = (8, cfg.vision.n_image_tokens, cfg.vision.clip_dim)
        out["patches"] = rng.standard_normal(shape).astype(np.float32)
        pre["patch_embeds"] = jnp.asarray(out["patches"])
    logits, cache = jax.jit(lambda p, b: bundle.prefill(p, b, pad_to={PAD}))(params, pre)
    served = [np.asarray(logits)]
    decode = jax.jit(bundle.decode)
    for t in range({N_DEC}):
        logits, cache = decode(params, cache, {{"tokens": jnp.asarray(fed[t])}})
        served.append(np.asarray(logits))
    out["prompt"], out["fed"], out["served"] = prompt, fed, np.stack(served)
    np.savez(f"{{OUT}}/serve_{{arch}}.npz", **out)

for arch, model, seq, steps in RUNS:
    cfg = sp_config(arch)
    bundle = build_model(cfg)
    params = bundle.init(jax.random.PRNGKey(0))   # the executor donates it
    batches = [batch_of(cfg, seq, i) for i in range(steps)]
    out = {{}}
    for i, b in enumerate(batches):
        tree_map_with_path(lambda p, x: out.__setitem__(f"batch{{i}}/" + p, np.asarray(x)), b)
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)
    ex = FusedExecutor(bundle.loss_fn, mcfg, optim.sgd(LR.get(arch, 1e-2), momentum=0.9),
                       mesh=make_sized_mesh(8, model), model_cfg=cfg)
    state = ex.init_state(params, jax.random.PRNGKey(1))
    losses, aux = [], []
    for b in batches:
        state, m = ex.step(state, b)
        losses.append(float(m["loss"]))
        aux.append(float(m.get("moe_aux", 0.0)))
        if arch == "mixtral-8x7b" and len(losses) == {CONTROL_STEPS}:   # the controls' reference
            tree_map_with_path(lambda p, x: out.__setitem__("control/" + p, np.asarray(x)),
                               jax.device_get(state.params))
    out["losses"], out["moe_aux"] = np.asarray(losses), np.asarray(aux)
    tree_map_with_path(lambda p, x: out.__setitem__("final/" + p, np.asarray(x)),
                       jax.device_get(state.params))
    np.savez(f"{{OUT}}/{{arch}}_8x{{model}}_s{{seq}}.npz", **out)
print("REFERENCE_OK")
'''

_RANKS = f'''
import dataclasses
import numpy as np
import torch
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.engine import FusedExecutor
from repro_torch.kernels import ops
from repro_torch.launch.sharding import batch_spec_tree, state_spec_tree, to_placements
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model, moe, partitioning
from repro_torch.models.convert import params_from_jax, to_reference
from repro_torch.runtime import make_sized_mesh
from repro_torch.utils import distributed
{_CONFIG}

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


# what the wrappers saw on this rank: each wkv call's (positions, from a
# state), each flash call's (queries, q_offset, keys, causal), and the
# routes the MoE layers dropped at the whole row's capacity
SEEN = {{"wkv": set(), "flash": set(), "dropped": [0]}}
_mix, _flash, _routing = ops.rwkv6_mix, ops.flash_attention, moe.make_routing


def mix_probe(r, k, v, w, u, init_state=None, impl=None):
    SEEN["wkv"].add((r.shape[1], init_state is not None))
    return _mix(r, k, v, w, u, init_state=init_state, impl=impl)


def flash_probe(q, k, v, *, causal=True, window=None, q_offset=0, impl=None):
    SEEN["flash"].add((q.shape[1], q_offset, k.shape[1], causal))
    return _flash(q, k, v, causal=causal, window=window, q_offset=q_offset, impl=impl)


def routing_probe(router, x, cfg):
    rt = _routing(router, x, cfg)
    c = moe._capacity(cfg.moe, moe._row_len(x.shape[1]))
    SEEN["dropped"][0] += int((rt.rank >= c).sum())
    return rt


ops.rwkv6_mix, ops.flash_attention, moe.make_routing = mix_probe, flash_probe, routing_probe


def load(tmp, name):
    return dict(np.load(f"{{tmp}}/{{name}}.npz"))


def model_of(cfg, sd):
    m = build_model(cfg).init(device="meta").to_empty(device="cpu")
    m.load_state_dict(sd)
    return m


def clear():
    SEEN["wkv"].clear()
    SEEN["flash"].clear()
    SEEN["dropped"][0] = 0


def probes():
    return {{"wkv": sorted(SEEN["wkv"]), "flash": sorted(SEEN["flash"]),
            "dropped": SEEN["dropped"][0]}}


_aux = moe.aux_loss


def aux_one_block(rt, cfg):
    """The control: the aux of this rank's own block, as if it were the
    whole sequence."""
    lay = partitioning.current_layout()
    with partitioning.layout_context(dataclasses.replace(lay, seq=None)):
        return _aux(rt, cfg)


def train(tmp, arch, model, seq):
    ref = load(tmp, f"{{arch}}_8x{{model}}_s{{seq}}")
    cfg = sp_config(arch)
    sd = params_from_jax(nest(load(tmp, f"serve_{{arch}}"), "init/"))
    batches = []
    for i in range(int(ref["losses"].shape[0])):
        b = nest(ref, f"batch{{i}}/")
        batches.append({{**{{k: torch.from_numpy(v) for k, v in b.items() if k != "ascent"}},
                        "ascent": {{k: torch.from_numpy(v) for k, v in b["ascent"].items()}}}})
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)
    mesh = make_sized_mesh(8, model)

    def params_of(state):
        # copies: a leaf held whole is the state's own tensor, which the
        # later steps update in place
        full = {{k: distributed.gather(v) for k, v in state.params.items()}}
        return to_reference(full, leaf=lambda t: t.numpy().copy())

    def run_steps(steps=len(batches)):
        ex = FusedExecutor(build_model(cfg).loss_fn, mcfg,
                           optim.sgd(LR.get(arch, 1e-2), momentum=0.9), mesh=mesh, model_cfg=cfg)
        state, losses, aux = ex.init_state(model_of(cfg, sd), 1), [], []
        out = {{"losses": losses, "moe_aux": aux}}
        for i, b in enumerate(batches[:steps]):
            state, m = ex.step(state, b)
            losses.append(float(m["loss"]))
            aux.append(float(m.get("moe_aux", 0.0)))
            if arch == "mixtral-8x7b" and i + 1 == {CONTROL_STEPS} < steps:
                out["early"] = params_of(state)    # where the controls stop
        out["params"] = params_of(state)
        return out

    clear()
    out = run_steps()
    out["probes"] = probes()
    if arch == "mixtral-8x7b":
        # the controls, on the first {CONTROL_STEPS} steps: each block's routes
        # ranked from 0 (no earlier blocks' counts); the aux of each rank's
        # own block
        _ranks = moe.block_ranks
        moe.block_ranks = lambda gate_idx, ranks, counts, r: ranks
        out["prefix_control"] = run_steps({CONTROL_STEPS})
        moe.block_ranks = _ranks
        moe.aux_loss = aux_one_block
        out["aux_control"] = run_steps({CONTROL_STEPS})
        moe.aux_loss = _aux
    return out


def serve(tmp, arch, model):
    ref = load(tmp, f"serve_{{arch}}")
    cfg = sp_config(arch)
    mesh = make_sized_mesh(8, model)
    bundle, whole = build_model(cfg), model_of(cfg, params_from_jax(nest(ref, "init/")))
    named = dict(whole.named_parameters())
    pl = to_placements(state_spec_tree(named, cfg, mesh), mesh)
    placed = {{k: distributed.place(v.detach(), mesh.device_mesh, pl[k]) for k, v in named.items()}}

    def batch_of(arrays):
        b = {{k: torch.from_numpy(v) for k, v in arrays.items()}}
        bpl = to_placements(batch_spec_tree(b, mesh), mesh)
        return {{k: distributed.place(v, mesh.device_mesh, bpl[k]) for k, v in b.items()}}

    pre = {{"tokens": ref["prompt"]}}
    if "frames" in ref:
        pre["enc_frames"] = ref["frames"]
    if "patches" in ref:
        pre["patch_embeds"] = ref["patches"]
    clear()
    served = []
    with torch.no_grad():
        logits, cache = make_prefill_step(bundle, mesh, {PAD})(placed, batch_of(pre))
        served.append(logits.numpy())
        prefill_probes = probes()
        decode = make_decode_step(bundle, mesh)
        for fed in ref["fed"]:
            logits, cache = decode(placed, cache, batch_of({{"tokens": fed}}))
            served.append(logits.numpy())
    return {{"served": served, "probes": prefill_probes,
            "cache": {{n: (tuple(t.shape), tuple(t.to_local().shape))
                      for n, t in cache["layers"].items()}},
            "rows": distributed.dp_index(mesh.device_mesh, [0]),
            "r": mesh.device_mesh.get_coordinate()[1]}}


def run(rank, world, tmp):
    out = {{}}
    for arch, model, seq, _ in RUNS:
        out[f"{{arch}}_8x{{model}}_s{{seq}}"] = train(tmp, arch, model, seq)
    for arch, model in sorted({{(a, m) for a, m, s, _ in RUNS if s % m == 0}}):
        out[f"serve_{{arch}}_8x{{model}}"] = serve(tmp, arch, model)
    return out
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (by npz name) and the port's 8 ranks' results:
    the reference subprocess first (one OpenMP thread), then the spawn of
    ranks."""
    tmp = tmp_path_factory.mktemp("sp_families")
    consts = f"OUT = {str(tmp)!r}\nRUNS = {RUNS!r}\nARCHS = {ARCHS!r}\nLR = {LR!r}\n"
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        out = run_py(consts + _REFERENCE, devices=8, timeout=3 * RANK_TIMEOUT_S)
    assert "REFERENCE_OK" in out
    names = [_key(a, m, s) for a, m, s, _ in RUNS] + [f"serve_{a}" for a in ARCHS]
    refs = {n: dict(np.load(tmp / f"{n}.npz")) for n in names}
    return refs, spawn_ranks(tmp, consts + _RANKS, timeout=4 * RANK_TIMEOUT_S)


def _final(ref, prefix="final/") -> dict:
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def _missed(got: dict, want: dict) -> list:
    return [k for k in want if not np.allclose(got[k], want[k], rtol=2e-5, atol=1e-6)]


@pytest.mark.parametrize("arch,model,seq,steps", RUNS)
def test_sp_family_async_sam_matches_the_reference(runs, arch, model, seq, steps):
    """SGD-momentum AsyncSAM steps with "fsdp_sp" on make_sized_mesh(8, m),
    each rank of the model group on its S / m positions (rwkv6's sequence
    of 18 whole on every rank of (8, 4)): the losses and the MoE aux on
    every rank, and every parameter after the steps, hold to the
    reference's sharded run at rtol 2e-5, atol 1e-6."""
    refs, ranks = runs
    key = _key(arch, model, seq)
    ref, r0 = refs[key], ranks[0][key]
    for r in ranks[1:]:
        assert r[key]["losses"] == r0["losses"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(r0["moe_aux"], ref["moe_aux"], rtol=2e-5, atol=1e-6)
    got, want = _flat(r0["params"]), _final(ref)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch,model,seq,steps", RUNS)
def test_sp_family_probes(runs, arch, model, seq, steps):
    """The same runs' probes on each rank r (its index along "model"): the
    wkv wrapper ran twice on the S / m positions of the block, once from no
    state and once from the chained one (once on the whole 18); flash ran
    on the block's queries at q_offset r S / m against all S keys (MLA's
    decompressed k and v, mixtral's window of 8, phi-3's image-prefixed
    sequence), whisper's encoder non-causal over the frames' blocks and its
    decoder's cross-attention over the whole encoder output; the MoE
    layers dropped routes at the whole row's capacity (on the later blocks:
    rank 0's 8 tokens send at most 8 routes to an expert, the capacity)."""
    _, ranks = runs
    key = _key(arch, model, seq)
    blk = seq // model if seq % model == 0 else seq
    if arch in ("mixtral-8x7b", "deepseek-v2-lite-16b"):
        assert sum(r[key]["probes"]["dropped"] for r in ranks) > 0
    for world_rank, r in enumerate(ranks):
        p = r[key]["probes"]
        off = blk * (world_rank % model) if blk < seq else 0
        if arch == "rwkv6-7b":
            want = [(blk, False), (blk, True)] if blk < seq else [(seq, False)]
            assert p["wkv"] == want, p["wkv"]
        elif arch == "whisper-tiny":
            assert p["flash"] == [(blk, off, seq, False), (blk, off, seq, True)], p["flash"]
        else:
            assert p["flash"] == [(blk, off, seq, True)], p["flash"]


@pytest.mark.parametrize("arch,model", sorted({(a, m) for a, m, s, _ in RUNS if s % m == 0}))
def test_sp_family_prefill_decode_match_the_reference(runs, arch, model):
    """Prefill of 8 prompts of 24 (whisper with 24 encoder frames, phi-3
    with its 8 image embeddings) into a cache of 32 and 4 decode steps on
    given tokens, params and batch placed over make_sized_mesh(8, m), each
    rank prefilling its block of the prompt: each rank's rows of the
    logits hold to the reference's meshless run at 1e-4 of their scale.
    The k/v (MLA's latents) caches lie on the sequence's blocks, the wkv
    state and the shifts whole on each rank's rows."""
    refs, ranks = runs
    ref = refs[f"serve_{arch}"]
    for r in ranks:
        a = r[f"serve_{arch}_8x{model}"]
        idx, n = a["rows"]
        rows = slice(idx * 8 // n, (idx + 1) * 8 // n)
        for step, got in enumerate(a["served"]):
            want = ref["served"][step][rows]
            assert np.abs(got - want).max() <= 1e-4 * float(np.abs(want).max()), (arch, step)
        blk = PROMPT // model
        if arch == "rwkv6-7b":
            assert a["probes"]["wkv"] == [(blk, False), (blk, True)], a["probes"]
        else:
            assert (blk, blk * a["r"], PROMPT, True) in a["probes"]["flash"], a["probes"]
        for name, (shape, local) in a["cache"].items():
            if name in ("k", "v", "c_kv", "k_rope", "cross_k", "cross_v"):
                assert local[2] * model == shape[2], (name, shape, local)


def test_moe_positions_without_the_prefix_miss_the_reference(runs):
    """The control: mixtral on (8, 4) with each block's routes ranked from
    0 in their experts' buffers (not after the row's earlier blocks'
    routes) keeps routes the whole row drops, and misses the reference's
    losses and the experts' parameters after CONTROL_STEPS steps."""
    refs, ranks = runs
    key = _key("mixtral-8x7b", 4, 32)
    ref, c = refs[key], ranks[0][key]["prefix_control"]
    assert len(c["losses"]) == CONTROL_STEPS
    # the port's run without the fault holds there
    assert not _missed(_flat(ranks[0][key]["early"]), _final(ref, "control/"))
    assert not np.allclose(c["losses"], ref["losses"][:CONTROL_STEPS], rtol=2e-5, atol=1e-6)
    missed = _missed(_flat(c["params"]), _final(ref, "control/"))
    assert "blocks/moe/we_in" in missed, missed


def test_moe_aux_of_one_block_misses_the_reference(runs):
    """The control: mixtral on (8, 4) with each rank's load-balancing aux
    taken over its own block's routes (P1 over the sequence blocks)
    misses the reference's aux and its router after CONTROL_STEPS steps."""
    refs, ranks = runs
    key = _key("mixtral-8x7b", 4, 32)
    ref, c = refs[key], ranks[0][key]["aux_control"]
    assert len(c["moe_aux"]) == CONTROL_STEPS
    assert not np.allclose(c["moe_aux"], ref["moe_aux"][:CONTROL_STEPS], rtol=2e-5, atol=1e-6)
    assert "blocks/moe/router" in _missed(_flat(c["params"]), _final(ref, "control/"))


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------

def _wkv_inputs(b, s, h, k, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)

    w = -torch.exp(t(b, s, h, k, scale=0.5) - 1.0)      # log decay < 0
    return t(b, s, h, k), t(b, s, h, k), t(b, s, h, k), w, t(h, k, scale=0.3)


def _chained_wkv(r, k, v, w, u, blocks):
    """The wkv scan cut into `blocks`: pass 1 per block from no state, the
    per-key prefix over the stacked finals and summed log decays, pass 2."""
    from repro_torch.kernels import ref
    from repro_torch.utils import distributed
    cut = [slice(i * r.shape[1] // blocks, (i + 1) * r.shape[1] // blocks)
           for i in range(blocks)]
    finals = [ref.rwkv6_scan_plain(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u)[1] for sl in cut]
    s_all = torch.stack(finals)
    l_all = torch.stack([w[:, sl].sum(dim=1) for sl in cut])        # (m, B, H, K)
    ys, last = [], None
    for i, sl in enumerate(cut):
        y, last = ref.rwkv6_scan_plain(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u,
                                       init_state=distributed.state_prefix(s_all, l_all, i))
        ys.append(y)
    return torch.cat(ys, dim=1), last


@pytest.mark.parametrize("blocks", (2, 4))
def test_state_prefix_with_a_per_key_decay_is_the_whole_wkv_scan(blocks):
    """The wkv scan over 4 heads of 8 x 8 and 16 positions, cut into 2 and
    4 blocks and chained by `distributed.state_prefix` with each block's
    per-key log decay (m, B, H, K), equals one sequential scan over the
    concatenated blocks: y and the final state, and the gradients of r, k,
    v, w and u through both passes, in fp32 (the plain scan's math) at 2e-6
    of their scale."""
    from repro_torch.kernels import ref
    args = [t.requires_grad_() for t in _wkv_inputs(2, 16, 4, 8, seed=3)]
    rng = np.random.default_rng(4)
    gy = torch.from_numpy(rng.standard_normal((2, 16, 4, 8))).float()
    gs = torch.from_numpy(rng.standard_normal((2, 4, 8, 8))).float()
    y, st = _chained_wkv(*args, blocks=blocks)
    y_w, st_w = ref.rwkv6_scan_plain(*args)
    for got, want in ((y, y_w), (st, st_w)):
        assert (got - want).abs().max() <= 2e-6 * float(want.detach().abs().max())
    got = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), args)
    want = torch.autograd.grad((y_w * gy).sum() + (st_w * gs).sum(), args)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 2e-6 * float(w.abs().max())


def test_state_prefix_without_the_key_dim_misses_the_wkv_scan():
    """The control: the same chain over 4 blocks with each block's decay
    averaged over the key dim (a per-head decay, the SSD's broadcast)
    misses the whole scan's final state by more than 1e-3 of its scale."""
    from repro_torch.kernels import ref
    from repro_torch.utils import distributed
    r, k, v, w, u = _wkv_inputs(2, 16, 4, 8, seed=3)
    cut = [slice(i, i + 4) for i in range(0, 16, 4)]
    s_all = torch.stack([ref.rwkv6_scan_plain(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u)[1]
                         for sl in cut])
    l_all = torch.stack([w[:, sl].sum(dim=1).mean(dim=-1) for sl in cut])   # (m, B, H)
    _, last = ref.rwkv6_scan_plain(r[:, 12:], k[:, 12:], v[:, 12:], w[:, 12:], u,
                                   init_state=distributed.state_prefix(s_all, l_all, 3))
    _, st_w = ref.rwkv6_scan_plain(r, k, v, w, u)
    assert (last - st_w).abs().max() > 1e-3 * float(st_w.abs().max())


@pytest.mark.parametrize("m", (2, 4, 8))
def test_moe_block_ranks_are_the_whole_rows_assign(m):
    """Top-2 routes of 4 rows of 32 tokens over 8 experts cut into m blocks
    of the sequence: each block's `assign` plus the earlier blocks'
    `expert_counts` (`block_ranks`) is the whole row's `assign`, so a
    capacity drops the same routes; without the earlier counts the ranks
    differ."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(m)
    gate_idx = torch.stack([torch.stack([torch.randperm(8, generator=gen)[:2]
                                         for _ in range(32)]) for _ in range(4)])   # (4, 32, 2)
    whole = moe.assign(gate_idx, 8, 8)
    blocks = gate_idx.chunk(m, dim=1)
    counts = torch.stack([moe.expert_counts(blk, 8) for blk in blocks])     # (m, 4, 8)
    parts, plain = [], []
    for r, blk in enumerate(blocks):
        ranks = moe.assign(blk, 8, 8)
        parts.append(moe.block_ranks(blk, ranks, counts, r))
        plain.append(ranks)
    assert torch.equal(torch.cat(parts, dim=1), whole)
    assert torch.equal(torch.cat(parts, dim=1) < 8, whole < 8)
    assert not torch.equal(torch.cat(plain, dim=1), whole)


def test_rwkv_sp_train_step_flops_by_hand():
    """Reduced rwkv6 with "fsdp_sp" traced on fake tensors over a fake
    (data 2, model 2) mesh, batch 8 x 64 (b' 2) placed over "data": rank 0
    computes its dp half of the rows on its 32 of 64 positions on whole
    weights. Its flops, backward twice forward: r, k, v, g and o (5 d^2 a
    token), the decay's LoRA (2 d R), the channel mix (2 d f + d^2), the
    logits (d V); the wkv kernels' formulas on the block, each run twice
    (from no state, then from the chained one). The chain's gathers and
    the halo are all-gathers over "model"."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import MethodConfig
    from repro_torch.engine import FusedExecutor
    from repro_torch.kernels import flat
    from repro_torch.kernels import rwkv6_scan as r6
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.launch.sharding import batch_spec_tree
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import make_optimizer
    from repro_torch.utils import abstract

    cfg = dataclasses.replace(get_config("rwkv6-7b", reduced=True), sharding_profile="fsdp_sp")
    b, s, bp, m, dp = 8, 64, 2, 2, 2
    bundle = build_model(cfg)
    with fake_world(4), flat.trace_kernels():
        mesh = make_host_mesh(model_axis=m, device="cpu")
        ex = FusedExecutor(bundle.loss_fn, MethodConfig(name="async_sam"),
                           make_optimizer("adamw", 1e-3, clip_norm=1.0), mesh=mesh,
                           model_cfg=cfg)
        state = ex.abstract_state(lambda: bundle.init(seed=0, device="cpu"), seed=1)
        with abstract.fake_mode_of(state):
            batch = dryrun.batch_spec(cfg, ShapeSpec("t", "train", s, b), ascent_fraction=0.25,
                                      device="cpu")
            batch = dryrun.place_tree(batch, batch_spec_tree(batch, mesh), mesh)
        lowered = ex.lower(state, batch)
    d, f, v, L, rank = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers, cfg.rwkv.decay_lora_rank
    hs = cfg.rwkv.head_dim
    rows = (b + bp) // dp
    tokens = rows * s // m
    per_layer = 5 * d * d + 2 * d * rank + 2 * d * f + d * d
    dense = 3 * 2 * tokens * (L * per_layer + d * v)
    scan_shape = (rows, s // m, d // hs, hs)
    scan = 2 * L * (r6._fwd_flops(scan_shape, scan_shape, scan_shape)
                    + r6._bwd_flops(scan_shape, scan_shape, scan_shape))
    assert lowered.kernels["rwkv6_scan_fwd"] == 4 * L
    assert lowered.kernels["rwkv6_scan_bwd"] == 4 * L
    assert lowered.flops == dense + scan
    kinds = {(c["kind"], c["group"]) for c in lowered.collectives}
    assert ("all-gather", m) in kinds, sorted(kinds)


def test_dryrun_traces_a_cell_under_the_other_profile():
    """`launch.dryrun --profile fsdp_sp` traces whisper-tiny's prefill_32k
    (a "tp" config) on the 16x16 fake mesh in the sequence-parallel
    layout: the record is ok; rank 0 runs 12 flash calls (4 encoder, 4
    decoder self- and 4 cross-attention layers) on its blocks; its
    collectives are the weights' and the k/v's all-gathers and the last
    block's broadcast, no tensor-parallel all-reduce."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    from repro_torch.launch import dryrun
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), OMP_NUM_THREADS="1")
    tag = f"test{os.getpid()}"
    path = dryrun.ARTIFACT_DIR / f"whisper-tiny_prefill_32k_16x16_{tag}.json"
    try:
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                               "whisper-tiny", "--shape", "prefill_32k", "--profile", "fsdp_sp",
                               "--device", "cpu", "--tag", tag],
                              capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        rec = json.loads(path.read_text())
    finally:
        path.unlink(missing_ok=True)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16", rec
    assert "'flash_attention_fwd': 12" in proc.stdout, proc.stdout
    assert {r["kind"] for r in rec["inventory"]} == {"all-gather", "collective-permute"}
