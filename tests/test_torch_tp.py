"""The reference's mesh compute layout in the port (`models.partitioning`):
per-layer weight gathers and tensor-parallel attention, MLP and vocabulary
over "model" (the "tp" profile), on a world of CPU ranks (gloo).

One reference subprocess (8 fake CPU devices, `tests/conftest.py:run_py`)
runs the reference's 4 sharded AsyncSAM steps of reduced olmo-1b, gemma-2b
and qwen3-8b on `make_sized_mesh(8, 2)` and its meshless prefill and decode;
one spawn of 8 gloo ranks (`test_torch_distributed.spawn_ranks`) runs the
port's on the same init and batches, with probes on the flash and decode
wrappers and on the weight gathers. The three archs cover heads that divide
the 2-way model axis (olmo-1b), MQA's single kv head computed whole on each
model rank (gemma-2b) and qk-norm with GQA (qwen3-8b). The vocab-parallel
loss and embedding run on 2 ranks against the plain ones, and a fake-tensor
trace on a (data 2, model 2) fake mesh counts rank 0's flops by hand.
"""
import numpy as np
import pytest

from conftest import run_py
from test_torch_distributed import RANK_TIMEOUT_S, _flat, spawn_ranks

ARCHS = ("olmo-1b", "gemma-2b", "qwen3-8b")
STEPS, PROMPT, N_DEC = 4, 12, 4

_REFERENCE = f'''
import jax, jax.numpy as jnp, numpy as np
from repro import optim
from repro.configs import get_config
from repro.core import MethodConfig
from repro.engine import FusedExecutor
from repro.models import build_model, synth_batch
from repro.runtime import make_sized_mesh
from repro.utils.trees import tree_map_with_path

for arch in ARCHS:
    cfg = get_config(arch, reduced=True)
    bundle = build_model(cfg)
    params = bundle.init(jax.random.PRNGKey(0))
    batches = [synth_batch(cfg, 8, 16, jax.random.PRNGKey(i), 0.5) for i in range({STEPS})]
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
                       mesh=make_sized_mesh(8, 2), model_cfg=cfg)
    state = ex.init_state(params, jax.random.PRNGKey(1))
    losses = []
    for b in batches:
        state, m = ex.step(state, b)
        losses.append(float(m["loss"]))
    out["losses"] = np.asarray(losses)
    tree_map_with_path(lambda p, x: out.__setitem__("final/" + p, np.asarray(x)),
                       jax.device_get(state.params))
    np.savez(f"{{OUT}}/{{arch}}.npz", **out)
print("REFERENCE_OK")
'''

_RANKS = '''
import dataclasses, weakref
import numpy as np
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.engine import FusedExecutor
from repro_torch.kernels import ops
from repro_torch.launch.sharding import batch_spec_tree, state_spec_tree, to_placements
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model, layers, transformer
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


# the wrappers' head counts (query, kv) as the model hands them over
HEADS = {"flash": set(), "decode": set()}


def probe(name, fn):
    def wrapped(q, k, v, *args, **kwargs):
        HEADS[name].add((q.shape[-2], k.shape[-2]))
        return fn(q, k, v, *args, **kwargs)
    return wrapped


ops.flash_attention = probe("flash", ops.flash_attention)
ops.decode_attention = probe("decode", ops.decode_attention)
# decode over a cache left on its sequence blocks (kv heads that do not
# divide "model"): each rank's part over its block
layers.decode_attention_part = probe("decode", layers.decode_attention_part)

# the bytes of gathered weights alive at once on this rank
LIVE = {"now": 0, "max": 0}
_gather = distributed.gather_for_compute


def counted_gather(x, *args, **kwargs):
    out = _gather(x, *args, **kwargs)
    if out is not x:
        n = out.numel() * out.element_size()
        LIVE["now"] += n
        LIVE["max"] = max(LIVE["max"], LIVE["now"])
        weakref.finalize(out, lambda: LIVE.__setitem__("now", LIVE["now"] - n))
    return out


def one_arch(arch, tmp, mesh):
    ref = dict(np.load(f"{tmp}/{arch}.npz"))
    cfg = get_config(arch, reduced=True)
    sd = params_from_jax(nest(ref, "init/"))
    batches = []
    for i in range(int(ref["losses"].shape[0])):
        b = nest(ref, f"batch{i}/")
        batches.append({**{k: torch.from_numpy(v) for k, v in b.items() if k != "ascent"},
                        "ascent": {k: torch.from_numpy(v) for k, v in b["ascent"].items()}})
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)

    def model(c=cfg):
        m = transformer.init_params(c, device="meta").to_empty(device="cpu")
        m.load_state_dict(sd)
        return m

    def train(c, steps):
        ex = FusedExecutor(build_model(c).loss_fn, mcfg, optim.sgd(1e-2, momentum=0.9),
                           mesh=mesh, model_cfg=c)
        state, losses = ex.init_state(model(c), 1), []
        for b in batches[:steps]:
            state, m = ex.step(state, b)
            losses.append(float(m["loss"]))
        return state, losses

    HEADS["flash"].clear()
    state, losses = train(cfg, len(batches))
    full = {k: distributed.gather(v) for k, v in state.params.items()}
    train_heads = sorted(HEADS["flash"])

    # (b) remat "full": each block's weights gathered in its checkpointed
    # function, again in its recompute
    distributed.gather_for_compute = counted_gather
    LIVE["now"] = LIVE["max"] = 0
    train(dataclasses.replace(cfg, remat="full"), 2)
    distributed.gather_for_compute = _gather
    whole = model()
    blocks = [sum(p.numel() * p.element_size() for p in b.parameters()) for b in whole.blocks]
    embed = sum(p.numel() * p.element_size() for p in whole.embedding.parameters())
    every = sum(p.numel() * p.element_size() for p in whole.parameters())

    # (c) prefill and decode on placed params and batch
    bundle = build_model(cfg)
    named = dict(whole.named_parameters())
    pl = to_placements(state_spec_tree(named, cfg, mesh), mesh)
    placed = {k: distributed.place(v.detach(), mesh.device_mesh, pl[k]) for k, v in named.items()}

    def batch_of(tokens):
        t = torch.from_numpy(tokens)
        return {"tokens": distributed.place(t, mesh.device_mesh,
                                            to_placements(batch_spec_tree({"tokens": t}, mesh),
                                                          mesh)["tokens"])}

    served, plain = [], []
    with torch.no_grad():
        p_logits, p_cache = bundle.prefill(whole, {"tokens": torch.from_numpy(ref["prompt"])},
                                           pad_to=ref["prompt"].shape[1] + len(ref["fed"]))
        plain.append(p_logits.numpy())
        for fed in ref["fed"]:
            p_logits, p_cache = bundle.decode(whole, p_cache, {"tokens": torch.from_numpy(fed)})
            plain.append(p_logits.numpy())
        HEADS["flash"].clear(), HEADS["decode"].clear()
        pad = ref["prompt"].shape[1] + len(ref["fed"])
        logits, cache = make_prefill_step(bundle, mesh, pad)(placed, batch_of(ref["prompt"]))
        served.append(logits.numpy())
        decode = make_decode_step(bundle, mesh)
        for fed in ref["fed"]:
            logits, cache = decode(placed, cache, batch_of(fed))
            served.append(logits.numpy())
    k = cache["layers"]["k"]
    return {"losses": losses, "params": to_reference(full, leaf=lambda t: t.numpy()),
            "train_heads": train_heads, "serve_heads": sorted(HEADS["flash"]),
            "decode_heads": sorted(HEADS["decode"]),
            "live_max": LIVE["max"], "bound": max(blocks) + embed, "every": every,
            "served": served, "plain": plain,
            "cache_k": (tuple(k.shape), tuple(k.to_local().shape), str(k.placements)),
            "rows": distributed.dp_index(mesh.device_mesh, [0])}


def run(rank, world, tmp):
    mesh = make_sized_mesh(8, 2)
    return {arch: one_arch(arch, tmp, mesh) for arch in ARCHS}
'''


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The reference's runs and the port's 8 ranks' results, by arch."""
    tmp = tmp_path_factory.mktemp("tp")
    out = run_py(f"OUT = {str(tmp)!r}\nARCHS = {ARCHS!r}\n" + _REFERENCE, devices=8,
                 timeout=RANK_TIMEOUT_S)
    assert "REFERENCE_OK" in out
    refs = {a: dict(np.load(tmp / f"{a}.npz")) for a in ARCHS}
    ranks = spawn_ranks(tmp, f"ARCHS = {ARCHS!r}\n" + _RANKS, timeout=2 * RANK_TIMEOUT_S)
    return refs, ranks


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_async_sam_matches_the_reference(tp_runs, arch):
    """(a) 4 SGD-momentum AsyncSAM steps on make_sized_mesh(8, 2), the
    attention, MLP and vocabulary tensor-parallel over the 2-way "model"
    axis and every weight gathered per layer: the losses on every rank, and
    every parameter after the steps, hold to the reference's sharded run at
    rtol 2e-5, atol 1e-6."""
    refs, ranks = tp_runs
    ref, r0 = refs[arch], ranks[0][arch]
    for r in ranks[1:]:
        assert r[arch]["losses"] == r0["losses"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-5, atol=1e-6)
    got = _flat(r0["params"])
    want = {k[len("final/"):]: v for k, v in ref.items() if k.startswith("final/")}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)


# the (query, kv) heads each rank's kernels see: H/2 query heads; the kv
# heads their own half where n_kv_heads divides 2, else the one kv head that
# gemma's query heads share
LOCAL_HEADS = {"olmo-1b": (2, 2), "gemma-2b": (2, 1), "qwen3-8b": (2, 1)}
# decode: the same, but gemma's cache stays on its sequence blocks (its one
# kv head does not divide "model"), over which each rank attends with every
# query head
DECODE_HEADS = {**LOCAL_HEADS, "gemma-2b": (4, 1)}


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_probe_local_heads_and_one_block_gathered(tp_runs, arch):
    """(b) The same run's probes: the flash wrapper (training, prefill) and
    decode attention saw H/2 query heads on every rank (gemma's decode, over
    the cache's sequence blocks, all H); with remat "full"
    the gathered weights alive at once on a rank never exceeded one block's
    and the embedding's whole bytes, which the whole-tree gather of every
    weight before the loss would exceed."""
    _, ranks = tp_runs
    for r in ranks:
        a = r[arch]
        assert a["train_heads"] == a["serve_heads"] == [LOCAL_HEADS[arch]], a
        assert a["decode_heads"] == [DECODE_HEADS[arch]], a
        assert 0 < a["live_max"] <= a["bound"] < a["every"], (a["live_max"], a["bound"])


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_decode_match_unsharded_and_the_reference(tp_runs, arch):
    """(c) Prefill of 8 prompts and 4 decode steps on given tokens, params
    and batch placed over make_sized_mesh(8, 2): each rank's rows of the
    logits (gathered whole over the vocabulary) match the unsharded port at
    1e-5 of their scale and the reference's meshless run at 2e-5; the k
    cache keeps its kv-head dim sharded over "model" where n_kv_heads
    divides it (gemma's single kv head: the reference's sequence split)."""
    refs, ranks = tp_runs
    ref = refs[arch]
    for r in ranks:
        a = r[arch]
        idx, n = a["rows"]
        rows = slice(idx * 8 // n, (idx + 1) * 8 // n)
        for step, (got, plain) in enumerate(zip(a["served"], a["plain"])):
            want = ref["served"][step]
            scale = float(np.abs(want).max())
            assert np.abs(got - plain[rows]).max() <= 1e-5 * scale, (arch, step)
            assert np.abs(got - want[rows]).max() <= 2e-5 * scale, (arch, step)
        shape, local, placements = a["cache_k"]
        if arch == "gemma-2b":
            assert placements == "(Shard(dim=1), Shard(dim=2))", placements
        else:
            assert placements == "(Shard(dim=1), Shard(dim=3))", placements
            assert local[3] * 2 == shape[3]
        assert local[1] * 4 == shape[1]


_VOCAB = '''
from repro_torch.configs import get_config
from repro_torch.models import layers as L, registry
from repro_torch.models.partitioning import activation_sharding
from repro_torch.runtime import make_sized_mesh


def run(rank, world, tmp):
    torch.manual_seed(0)
    cfg = get_config("olmo-1b", reduced=True)
    v, d = cfg.vocab_size, cfg.d_model
    table = torch.randn(v, d, dtype=torch.float64)
    logits = torch.randn(3, 5, v, dtype=torch.float64) * 4
    labels = torch.randint(0, v, (3, 5))
    labels[0, :2] = -1
    tokens = torch.randint(0, v, (3, 5))
    w = torch.randn(3, 5, d, dtype=torch.float64)
    cfg = __import__("dataclasses").replace(cfg, compute_dtype="float64")
    shard = slice(rank * v // 2, (rank + 1) * v // 2)

    lp = logits.clone().requires_grad_()
    plain = registry.cross_entropy(lp, labels)
    plain.backward()
    tp = table.clone().requires_grad_()
    emb_plain = L.embed_tokens({"embed": tp}, tokens, cfg)
    (emb_plain * w).sum().backward()

    with activation_sharding(make_sized_mesh(2, 2)):
        ll = logits[..., shard].clone().requires_grad_()
        par = registry.vocab_parallel_cross_entropy(ll, labels, cfg)
        par.backward()
        tl = table[shard].clone().requires_grad_()
        emb = L.embed_tokens({"embed": tl}, tokens, cfg)
        (emb * w).sum().backward()
    return {"ce": (float(par), float(plain)),
            "ce_grad": float((ll.grad - lp.grad[..., shard]).abs().max()),
            "emb": float((emb - emb_plain).abs().max()),
            "emb_grad": float((tl.grad - tp.grad[shard]).abs().max())}
'''


def test_vocab_parallel_loss_and_embedding_match_the_plain(tmp_path):
    """(d) On 2 ranks of a (1, 2) mesh, each holding half the vocabulary:
    the vocab-parallel cross entropy (labels masked at -1 included) and the
    vocab-parallel embedding lookup match `registry.cross_entropy` and the
    whole table's lookup, values and gradients (each rank's slice), at
    1e-6, in float64."""
    for r in spawn_ranks(tmp_path, _VOCAB, world=2):
        got, want = r["ce"]
        assert abs(got - want) <= 1e-6 * abs(want)
        assert r["ce_grad"] <= 1e-6 and r["emb"] == 0.0 and r["emb_grad"] == 0.0, r


def test_tp_train_step_flops_by_hand():
    """(e) Reduced olmo-1b traced on fake tensors over a fake (data 2,
    model 2) mesh, batch 8 x 64 (b' 2) placed over "data": rank 0 computes
    its dp half of the rows on its model half of the heads, the MLP's d_ff
    and the vocabulary. Its flops: the matmuls of q, k, v, o (4 d^2 / 2 a
    token) and the SwiGLU MLP (3 d f / 2), the logits (d V / 2), backward
    twice forward; the flash op on h / 2 heads and its plain backward (as
    `test_torch_dryrun.test_train_step_flops_by_hand` counts them)."""
    from repro_torch.configs import get_config
    from repro_torch.core import MethodConfig
    from repro_torch.engine import FusedExecutor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flat
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.launch.sharding import batch_spec_tree
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import make_optimizer
    from repro_torch.utils import abstract

    cfg = get_config("olmo-1b", reduced=True)
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
    d, f, v, hd, h, L = (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.resolved_head_dim,
                         cfg.n_heads, cfg.n_layers)
    tokens = (b + bp) // dp * s
    dense = 3 * 2 * tokens * (L * (4 * d * d + 3 * d * f) + d * v) // m
    pairs = fa.visible_pairs(s, s, True, None)
    flash = 2 * (hd + hd) * (h // m) * pairs * L * (b + bp) // dp
    plain_bwd = 3 * 2 * 2 * hd * (h // m) * s * s * L * (b + bp) // dp
    assert lowered.kernels["flash_attention_fwd"] == 2 * L
    assert lowered.flops == dense + flash + plain_bwd
    # the tensor-parallel all-reduces over "model" are in the inventory
    assert any(c["group"] == m and c["kind"] == "all-reduce"
               for c in lowered.collectives), lowered.collectives[:5]
