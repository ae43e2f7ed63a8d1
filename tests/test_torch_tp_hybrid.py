"""The reference's "tp" layout for the hybrid family in the port
(`models.ssm`, `models.transformer`, `models.partitioning`): mamba2 on its
heads (`wz`, `wx`, `wdt` and the x conv on the rank's d_inner columns, the
SSD scan on its heads with B and C whole, the gated norm's sum of squares
summed over "model", `w_out` row-parallel) and zamba2's shared attention
and MLP tensor-parallel with their LoRA added once, on a world of CPU
ranks (gloo).

One reference subprocess (8 fake CPU devices, `tests/conftest.py:run_py`)
runs the reference's 4 sharded AsyncSAM SGD-momentum steps of reduced
zamba2-1.2b ("tp", its reduced config's profile) on `make_sized_mesh(8,
2)`, `(8, 4)` and `(8, 8)` (4, 2 and 1 of its 8 SSD heads a rank; its 4
attention heads split, split and, not dividing 8, whole) and its meshless
prefill and decode; then one spawn of 8 gloo ranks
(`test_torch_distributed.spawn_ranks`) runs the port's on the same init
and batches, with probes on the SSD and flash wrappers and two controls
that must miss the reference after its first 2 steps: the gated norm over
the rank's columns alone, and the LoRA added on every rank before the
sums. In process: the
m shares of a mamba2 layer (`partitioning.mamba_share`) against the whole
layer, and a fake-tensor trace on a (data 2, model 2) fake mesh whose
flops are counted by hand.
"""
import numpy as np
import pytest
import torch

from conftest import run_py
from test_torch_distributed import RANK_TIMEOUT_S, _flat, spawn_ranks

ARCH = "zamba2-1.2b"
MODELS = (2, 4, 8)
STEPS, PROMPT, PAD, N_DEC = 4, 24, 32, 4
# the controls run the first CONTROL_STEPS steps, held against the
# reference after as many
CONTROL_STEPS = 2


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
cfg = get_config("{ARCH}", reduced=True)
assert cfg.sharding_profile == "tp"
bundle = build_model(cfg)
params = bundle.init(jax.random.PRNGKey(0))
out = {{}}
tree_map_with_path(lambda p, x: out.__setitem__("init/" + p, np.asarray(x)), params)
rng = np.random.default_rng(7)
prompt = rng.integers(0, cfg.vocab_size, (8, {PROMPT})).astype(np.int32)
fed = rng.integers(0, cfg.vocab_size, ({N_DEC}, 8, 1)).astype(np.int32)
logits, cache = jax.jit(lambda p, b: bundle.prefill(p, b, pad_to={PAD}))(
    params, {{"tokens": jnp.asarray(prompt)}})
served = [np.asarray(logits)]
decode = jax.jit(bundle.decode)
for t in range({N_DEC}):
    logits, cache = decode(params, cache, {{"tokens": jnp.asarray(fed[t])}})
    served.append(np.asarray(logits))
out["prompt"], out["fed"], out["served"] = prompt, fed, np.stack(served)
np.savez(f"{{OUT}}/serve.npz", **out)

for model in {MODELS!r}:
    params = bundle.init(jax.random.PRNGKey(0))   # the executor donates it
    batches = [synth_batch(cfg, 8, 16, jax.random.PRNGKey(i), 0.5) for i in range({STEPS})]
    out = {{}}
    for i, b in enumerate(batches):
        tree_map_with_path(lambda p, x: out.__setitem__(f"batch{{i}}/" + p, np.asarray(x)), b)
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)
    ex = FusedExecutor(bundle.loss_fn, mcfg, optim.sgd(1e-2, momentum=0.9),
                       mesh=make_sized_mesh(8, model), model_cfg=cfg)
    state = ex.init_state(params, jax.random.PRNGKey(1))
    losses = []
    for b in batches:
        state, m = ex.step(state, b)
        losses.append(float(m["loss"]))
        if model == 2 and len(losses) == {CONTROL_STEPS}:   # the controls' reference
            tree_map_with_path(lambda p, x: out.__setitem__("control/" + p, np.asarray(x)),
                               jax.device_get(state.params))
    out["losses"] = np.asarray(losses)
    tree_map_with_path(lambda p, x: out.__setitem__("final/" + p, np.asarray(x)),
                       jax.device_get(state.params))
    np.savez(f"{{OUT}}/train_8x{{model}}.npz", **out)
print("REFERENCE_OK")
'''

_RANKS = f'''
import numpy as np
import torch
from torch.distributed.tensor import DTensor
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.engine import FusedExecutor
from repro_torch.kernels import ops
from repro_torch.launch.sharding import batch_spec_tree, state_spec_tree, to_placements
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model, layers, partitioning, transformer
from repro_torch.models.convert import params_from_jax, to_reference
from repro_torch.runtime import make_sized_mesh
from repro_torch.utils import distributed

CFG = get_config("{ARCH}", reduced=True)


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


# the heads each SSD call got (x's and a's; the carried state's in decode,
# or -1) and the query heads of each flash and decode attention call
SEEN = {{"ssd": set(), "flash": set()}}
_mix, _step, _flash, _decode = (ops.mamba2_mix, ops.mamba2_decode_step, ops.flash_attention,
                                ops.decode_attention)


def mix_probe(x, dt, a, b, c, d, *, chunk=128, init_state=None, impl=None):
    SEEN["ssd"].add((x.shape[2], a.shape[0], b.shape[2], -1))
    return _mix(x, dt, a, b, c, d, chunk=chunk, init_state=init_state, impl=impl)


def step_probe(x, dt, a, b, c, d, state, *, impl=None):
    SEEN["ssd"].add((x.shape[2], a.shape[0], b.shape[2], state.shape[1]))
    return _step(x, dt, a, b, c, d, state, impl=impl)


def flash_probe(q, k, v, **kwargs):
    SEEN["flash"].add(q.shape[2])
    return _flash(q, k, v, **kwargs)


ops.mamba2_mix, ops.mamba2_decode_step, ops.flash_attention = mix_probe, step_probe, flash_probe


def lora_on_every_rank(shared, lora, x, cfg, *, positions, cache=None):
    """The control: each rank adds the LoRA branches to its partial sums,
    so the model group's sums count them m times."""
    lay = partitioning.tp_layout(cfg)
    dt = layers.cdtype(cfg)
    xn = layers.norm_apply(shared["ln1"], x, cfg)
    h, new_cache = layers.attention_apply(shared["attn"], xn, cfg, positions=positions,
                                          cache=cache)
    lo = (xn @ lora["attn_a"].to(dt)) @ lora["attn_b"].to(dt)
    x = x + h + distributed.reduce_from_model(lo, lay.model_group)
    x2n = layers.norm_apply(shared["ln2"], x, cfg)
    h2 = layers.mlp_apply(shared["mlp"], x2n, cfg)
    lo2 = (x2n @ lora["mlp_a"].to(dt)) @ lora["mlp_b"].to(dt)
    return x + h2 + distributed.reduce_from_model(lo2, lay.model_group), new_cache


def load(tmp, name):
    return dict(np.load(f"{{tmp}}/{{name}}.npz"))


def model_of(sd):
    m = build_model(CFG).init(device="meta").to_empty(device="cpu")
    m.load_state_dict(sd)
    return m


def train(tmp, model):
    ref = load(tmp, f"train_8x{{model}}")
    sd = params_from_jax(nest(load(tmp, "serve"), "init/"))
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
        ex = FusedExecutor(build_model(CFG).loss_fn, mcfg, optim.sgd(1e-2, momentum=0.9),
                           mesh=mesh, model_cfg=CFG)
        state, losses = ex.init_state(model_of(sd), 1), []
        out = {{"losses": losses}}
        for i, b in enumerate(batches[:steps]):
            state, m = ex.step(state, b)
            losses.append(float(m["loss"]))
            if model == 2 and i + 1 == {CONTROL_STEPS} < steps:
                out["early"] = params_of(state)    # where the controls stop
        out["params"] = params_of(state)
        return out

    for seen in SEEN.values():
        seen.clear()
    out = run_steps()
    out["ssd"], out["flash"] = sorted(SEEN["ssd"]), sorted(SEEN["flash"])
    if model == 2:
        # the controls, on the first {CONTROL_STEPS} steps: the gated norm's sum
        # of squares over the rank's columns alone; the LoRA added on every
        # rank before the sums
        _sum = distributed.all_reduce_sum
        distributed.all_reduce_sum = lambda x, group: x
        out["norm_control"] = run_steps({CONTROL_STEPS})
        distributed.all_reduce_sum = _sum
        _shared = transformer.shared_block_apply
        transformer.shared_block_apply = lora_on_every_rank
        out["lora_control"] = run_steps({CONTROL_STEPS})
        transformer.shared_block_apply = _shared
    return out


def serve(tmp, model):
    ref = load(tmp, "serve")
    mesh = make_sized_mesh(8, model)
    bundle, whole = build_model(CFG), model_of(params_from_jax(nest(ref, "init/")))
    named = dict(whole.named_parameters())
    pl = to_placements(state_spec_tree(named, CFG, mesh), mesh)
    placed = {{k: distributed.place(v.detach(), mesh.device_mesh, pl[k]) for k, v in named.items()}}

    def batch_of(arrays):
        b = {{k: torch.from_numpy(v) for k, v in arrays.items()}}
        bpl = to_placements(batch_spec_tree(b, mesh), mesh)
        return {{k: distributed.place(v, mesh.device_mesh, bpl[k]) for k, v in b.items()}}

    for seen in SEEN.values():
        seen.clear()
    served = []
    with torch.no_grad():
        logits, cache = make_prefill_step(bundle, mesh, {PAD})(
            placed, batch_of({{"tokens": ref["prompt"]}}))
        served.append(logits.numpy())
        decode = make_decode_step(bundle, mesh)
        for fed in ref["fed"]:
            logits, cache = decode(placed, cache, batch_of({{"tokens": fed}}))
            served.append(logits.numpy())
    leaves = {{**{{n: t for n, t in cache["layers"].items()}},
              **{{"shared_" + n: t for n, t in cache["shared"].items()}}}}
    return {{"served": served, "ssd": sorted(SEEN["ssd"]), "flash": sorted(SEEN["flash"]),
            "cache": {{n: (tuple(t.shape), tuple(t.to_local().shape)) for n, t in leaves.items()}},
            "rows": distributed.dp_index(mesh.device_mesh, [0])}}


def run(rank, world, tmp):
    return {{**{{f"train_8x{{m}}": train(tmp, m) for m in {MODELS!r}}},
            **{{f"serve_8x{{m}}": serve(tmp, m) for m in {MODELS!r}}}}}
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (by npz name) and the port's 8 ranks' results:
    the reference subprocess first (one OpenMP thread), then the spawn of
    ranks."""
    tmp = tmp_path_factory.mktemp("tp_hybrid")
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        out = run_py(f"OUT = {str(tmp)!r}\n" + _REFERENCE, devices=8,
                     timeout=2 * RANK_TIMEOUT_S)
    assert "REFERENCE_OK" in out
    names = [f"train_8x{m}" for m in MODELS] + ["serve"]
    refs = {n: dict(np.load(tmp / f"{n}.npz")) for n in names}
    return refs, spawn_ranks(tmp, _RANKS, timeout=3 * RANK_TIMEOUT_S)


def _final(ref, prefix="final/") -> dict:
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def _missed(got: dict, want: dict) -> list:
    return [k for k in want
            if not np.allclose(got[k], want[k], rtol=2e-5, atol=1e-6)]


@pytest.mark.parametrize("model", MODELS)
def test_hybrid_tp_async_sam_matches_the_reference(runs, model):
    """4 SGD-momentum AsyncSAM steps of reduced zamba2 in the "tp" layout
    on make_sized_mesh(8, m): mamba2 on 8 / m of its 8 heads, the shared
    attention on 2, 1 and (not dividing 8) all 4 of its heads, the MLP on
    its d_ff / m: the losses on every rank, and every parameter after the
    steps, hold to the reference's sharded run at rtol 2e-5, atol 1e-6."""
    refs, ranks = runs
    key = f"train_8x{model}"
    ref, r0 = refs[key], ranks[0][key]
    for r in ranks[1:]:
        assert r[key]["losses"] == r0["losses"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-5, atol=1e-6)
    got, want = _flat(r0["params"]), _final(ref)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("model", MODELS)
def test_ssd_and_attention_run_on_the_ranks_heads(runs, model):
    """Every SSD call of the training run and of the serve step got 8 / m
    heads of x and of a, with B and C of the single group whole (decode's
    carried state on the same heads); flash got the shared attention's 4 /
    m heads where m divides 4, else all 4. The serve step's cache holds
    each rank's rows, its x conv tail on its d_inner / m channels and its
    SSM state on its heads, its BC conv tail whole, and the shared
    attention's k/v on its kv heads (on (8, 8), whose model axis the 4
    heads do not divide, on its sequence blocks)."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH, reduced=True)
    _, ranks = runs
    d_inner = cfg.ssm.expand * cfg.d_model
    heads = d_inner // cfg.ssm.head_dim
    h = heads // model
    attn = cfg.n_heads // model if cfg.n_heads % model == 0 else cfg.n_heads
    for r in ranks:
        t = r[f"train_8x{model}"]
        assert t["ssd"] == [(h, h, 1, -1)], t["ssd"]
        assert t["flash"] == [attn], t["flash"]
        s = r[f"serve_8x{model}"]
        assert s["ssd"] == sorted({(h, h, 1, -1), (h, h, 1, h)}), s["ssd"]
        assert s["flash"] == [attn], s["flash"]
        shape, local = s["cache"]["conv_x"]
        assert shape[-1] == d_inner and local[-1] == d_inner // model, (shape, local)
        shape, local = s["cache"]["ssm"]
        assert shape[2] == heads and local[2] == h, (shape, local)
        shape, local = s["cache"]["conv_bc"]
        assert local[-1] == shape[-1] // model, (shape, local)   # held as the rules place it
        shape, local = s["cache"]["shared_k"]
        if attn < cfg.n_heads:
            assert local[3] == shape[3] // model and local[2] == shape[2], (shape, local)
        else:
            assert local[2] == shape[2] // model and local[3] == shape[3], (shape, local)


def test_gated_norm_without_its_sum_misses_the_reference(runs):
    """The control: on (8, 2) the gated RMSNorm's mean of squares over the
    rank's 64 of 128 columns alone (no sum over "model") misses the
    reference's losses and the mixers' parameters after CONTROL_STEPS
    steps."""
    refs, ranks = runs
    ref, c = refs["train_8x2"], ranks[0]["train_8x2"]["norm_control"]
    assert len(c["losses"]) == CONTROL_STEPS
    # the port's run without the fault holds there
    assert not _missed(_flat(ranks[0]["train_8x2"]["early"]), _final(ref, "control/"))
    assert not np.allclose(c["losses"], ref["losses"][:CONTROL_STEPS], rtol=2e-5, atol=1e-6)
    missed = _missed(_flat(c["params"]), _final(ref, "control/"))
    assert "blocks/mixer/w_out" in missed and "blocks/mixer/wz" in missed, missed


def test_lora_added_on_every_rank_misses_the_reference(runs):
    """The control: on (8, 2) the shared block's LoRA branches added to
    each rank's partial attention and MLP outputs before their sums (so the
    sums count them twice) miss the reference's parameters after
    CONTROL_STEPS steps, the LoRA's among them."""
    refs, ranks = runs
    ref, c = refs["train_8x2"], ranks[0]["train_8x2"]["lora_control"]
    missed = _missed(_flat(c["params"]), _final(ref, "control/"))
    assert "lora/attn_b" in missed and "lora/mlp_b" in missed, missed


@pytest.mark.parametrize("model", MODELS)
def test_hybrid_tp_prefill_decode_match_the_reference(runs, model):
    """Prefill of 8 prompts of 24 into a cache of 32 and 4 decode steps on
    given tokens, params and batch placed over make_sized_mesh(8, m): each
    rank's rows of the logits hold to the reference's meshless run at 1e-4
    of their scale."""
    refs, ranks = runs
    ref = refs["serve"]
    for r in ranks:
        a = r[f"serve_8x{model}"]
        idx, n = a["rows"]
        rows = slice(idx * 8 // n, (idx + 1) * 8 // n)
        for step, got in enumerate(a["served"]):
            want = ref["served"][step][rows]
            assert np.abs(got - want).max() <= 1e-4 * float(np.abs(want).max()), (model, step)


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", (2, 4, 8))
def test_mamba_shares_sum_to_the_whole_layer(m):
    """The m shares of a reduced zamba2 mamba2 layer (`mamba2_gated` on
    `partitioning.mamba_share` of whole weights, from each share's heads of
    a carried state and conv tails), their sums of squares added and each
    normed and projected (`mamba2_out`), sum to the whole `mamba2_apply`;
    their states joined on the heads are its state and the x conv tails
    joined on the channels its tail: forward and the gradients of x and
    every leaf, fp32 at 2e-5 (the conv tails exactly)."""
    from repro_torch.configs import get_config
    from repro_torch.models import partitioning, ssm
    cfg = get_config(ARCH, reduced=True)
    gen = torch.Generator().manual_seed(0)
    leaves = {k: (torch.randn(s, generator=gen)
                  * (s[-2] ** -0.5 if len(s) == 2 and k not in ("conv_x_w", "conv_bc_w")
                     else 0.3)).requires_grad_()
              for k, s in ssm.mamba2_shapes(cfg).items()}
    b, s = 2, 12
    x = torch.randn(b, s, cfg.d_model, generator=gen).requires_grad_()
    w = torch.randn(b, s, cfg.d_model, generator=gen)
    cache = {name: torch.randn(t.shape, generator=gen) * 0.3
             for name, t in ssm.mamba2_cache_shape(cfg, b, "cpu").items()}
    y, c = ssm.mamba2_apply(leaves, x, cfg, cache=cache)
    want = torch.autograd.grad((y * w).sum(), [x, *leaves.values()])

    d_inner = cfg.ssm.expand * cfg.d_model
    di, h = d_inner // m, d_inner // cfg.ssm.head_dim // m
    parts = []
    for r in range(m):
        mine = {"conv_x": cache["conv_x"][..., r * di:(r + 1) * di], "conv_bc": cache["conv_bc"],
                "ssm": cache["ssm"][:, r * h:(r + 1) * h]}
        parts.append(ssm.mamba2_gated(partitioning.mamba_share(leaves, r, m), x, cfg, r, m,
                                      cache=mine))
    sq = sum(yf.square().sum(dim=-1, keepdim=True) for yf, _ in parts)
    total = sum(ssm.mamba2_out(partitioning.mamba_share(leaves, r, m), yf, sq, cfg, r, m)
                for r, (yf, _) in enumerate(parts))
    got = torch.autograd.grad((total * w).sum(), [x, *leaves.values()])
    torch.testing.assert_close(total, y, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(torch.cat([p[1]["ssm"] for p in parts], dim=1), c["ssm"],
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(torch.cat([p[1]["conv_x"] for p in parts], dim=-1), c["conv_x"],
                               rtol=0, atol=0)
    for g, g_want in zip(got, want):
        torch.testing.assert_close(g, g_want, rtol=2e-5, atol=2e-5)


def test_hybrid_tp_train_step_flops_by_hand():
    """Reduced zamba2 traced on fake tensors over a fake (data 2, model 2)
    mesh, batch 8 x 64 (b' 2) placed over "data": rank 0 computes its dp
    half of the rows, each mamba2 layer on 4 of its 8 heads (wz, wx, wdt
    and w_out on half their d_inner or heads, wbc whole), the shared block
    on 2 of its 4 heads and half its d_ff (its LoRA whole), and half the
    vocabulary. Its flops, backward twice forward, and the SSD and flash
    kernels' formulas on the rank's heads with flash's plain backward (as
    `test_torch_tp.test_tp_train_step_flops_by_hand` counts it). The
    gated norm's sums and the row-parallel sums are all-reduces over
    "model"."""
    from repro_torch.configs import get_config
    from repro_torch.core import MethodConfig
    from repro_torch.engine import FusedExecutor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flat
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.launch.sharding import batch_spec_tree
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import make_optimizer
    from repro_torch.utils import abstract

    cfg = get_config(ARCH, reduced=True)
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
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    sc = cfg.ssm
    d_inner = sc.expand * d
    heads, bc = d_inner // sc.head_dim, 2 * sc.n_groups * sc.d_state
    hd, h, r = cfg.resolved_head_dim, cfg.n_heads, cfg.hybrid.lora_rank
    n_inv = (L + cfg.hybrid.period - 1) // cfg.hybrid.period
    rows = (b + bp) // dp
    tokens = rows * s
    mamba = (2 * d * d_inner + d * heads + d_inner * d) // m + d * bc
    shared = (4 * d * h * hd + 3 * d * f) // m + 4 * d * r
    dense = 3 * 2 * tokens * (L * mamba + n_inv * shared + d * v // m)
    x_shape = (rows, s, heads // m, sc.head_dim)
    bc_shape = (rows, s, sc.n_groups, sc.d_state)
    ssd = L * (m2._fwd_flops(x_shape, (rows, s, heads // m), (heads // m,), bc_shape, bc_shape)
               + m2._bwd_flops(x_shape, (rows, s, heads // m), (heads // m,), bc_shape,
                               bc_shape))
    flash = 2 * (hd + hd) * (h // m) * fa.visible_pairs(s, s, True, None) * n_inv * rows
    plain_bwd = 3 * 2 * 2 * hd * (h // m) * s * s * n_inv * rows
    assert lowered.kernels["mamba2_scan_fwd"] == 2 * L
    assert lowered.kernels["flash_attention_fwd"] == 2 * n_inv
    assert lowered.flops == dense + ssd + flash + plain_bwd
    kinds = {(c["kind"], c["group"]) for c in lowered.collectives}
    assert ("all-reduce", m) in kinds, sorted(kinds)
