"""The reference's "tp" layout for rwkv6 and the encoder-decoder in the port
(`models.rwkv`, `models.encdec`, `models.partitioning`): rwkv6's time mix
on its heads, or on its d_model columns where "model" does not divide the
heads, and its channel mix on its d_ff, its wkv decode state on its heads
where they split; whisper's attention, cross-attention, MLP and vocabulary
over "model", and its decode over the cache's sequence blocks where its
heads do not divide "model", on a world of CPU ranks (gloo).

For each arch, one after the other: one reference subprocess (8 fake CPU
devices, `tests/conftest.py:run_py`) runs the reference's 4 sharded
AsyncSAM SGD-momentum steps (of reduced rwkv6-7b on `make_sized_mesh(8,
2)`, `(8, 4)` and `(8, 8)`: 2, 1 and, not dividing, 4 of its 4 heads a
rank, its d_ff of 224 on every one; of reduced whisper-tiny on `(8, 2)`,
everything split, and `(8, 8)`, its 4 heads whole, its d_ff of 128 and
vocabulary of 256 split) and the meshless prefill and decode; then one
spawn of 8 gloo ranks (`test_torch_distributed.spawn_ranks`) runs the
port's on the same init and batches, with probes on the wkv wrapper, the
time mix's weights, the decode parts and the cache's moves, and two
controls that must miss. In process: the m time-mix (heads or columns)
and channel-mix shares of a layer against the whole layer, whisper's
cross-attention decode over blocks merged against the whole, and
fake-tensor traces on (data 2, model 2) and (data 1, model 8) fake meshes
whose rwkv6 flops are counted by hand, and on (data 2, model 1) whose
weight gathers with `weight_stream_bf16` move bf16.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import run_py
from test_torch_distributed import RANK_TIMEOUT_S, _flat, spawn_ranks

# (arch, devices, model axis) of each sharded training and serving run
RUNS = (("rwkv6-7b", 8, 2), ("rwkv6-7b", 8, 4), ("rwkv6-7b", 8, 8),
        ("whisper-tiny", 8, 2), ("whisper-tiny", 8, 8))
ARCHS = ("rwkv6-7b", "whisper-tiny")
# rwkv6 at the learning rate of its trajectory (tests/test_torch_rwkv.py)
LR = {"rwkv6-7b": 3e-5, "whisper-tiny": 1e-2}
STEPS, PROMPT, PAD, N_DEC = 4, 24, 32, 4


def _key(arch, devices, model):
    return f"{arch}_{devices}x{model}"


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
    out = {{}}
    tree_map_with_path(lambda p, x: out.__setitem__("init/" + p, np.asarray(x)), params)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (8, {PROMPT})).astype(np.int32)
    fed = rng.integers(0, cfg.vocab_size, ({N_DEC}, 8, 1)).astype(np.int32)
    pre = {{"tokens": jnp.asarray(prompt)}}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((8, {PROMPT}, cfg.d_model)).astype(np.float32)
        pre["enc_frames"] = jnp.asarray(out["frames"])
    logits, cache = jax.jit(lambda p, b: bundle.prefill(p, b, pad_to={PAD}))(params, pre)
    served = [np.asarray(logits)]
    decode = jax.jit(bundle.decode)
    for t in range({N_DEC}):
        logits, cache = decode(params, cache, {{"tokens": jnp.asarray(fed[t])}})
        served.append(np.asarray(logits))
    out["prompt"], out["fed"], out["served"] = prompt, fed, np.stack(served)
    np.savez(f"{{OUT}}/serve_{{arch}}.npz", **out)

for arch, devices, model in RUNS:
    cfg = get_config(arch, reduced=True)
    bundle = build_model(cfg)
    params = bundle.init(jax.random.PRNGKey(0))   # the executor donates it
    batches = [synth_batch(cfg, 8, 16, jax.random.PRNGKey(i), 0.5) for i in range({STEPS})]
    out = {{}}
    for i, b in enumerate(batches):
        tree_map_with_path(lambda p, x: out.__setitem__(f"batch{{i}}/" + p, np.asarray(x)), b)
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)
    ex = FusedExecutor(bundle.loss_fn, mcfg, optim.sgd(LR[arch], momentum=0.9),
                       mesh=make_sized_mesh(devices, model), model_cfg=cfg)
    state = ex.init_state(params, jax.random.PRNGKey(1))
    losses = []
    for b in batches:
        state, m = ex.step(state, b)
        losses.append(float(m["loss"]))
    out["losses"] = np.asarray(losses)
    tree_map_with_path(lambda p, x: out.__setitem__("final/" + p, np.asarray(x)),
                       jax.device_get(state.params))
    np.savez(f"{{OUT}}/{{arch}}_{{devices}}x{{model}}.npz", **out)
print("REFERENCE_OK")
'''

_RANKS = '''
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
from repro_torch.models import build_model, layers, partitioning, rwkv
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


# the heads each wkv call got (r's, u's, the initial state's or -1), the
# shapes of the time mix's five matrices as each call got them, the decode
# parts (query heads, kv heads, block length, the block's offset, all of
# the block valid) and the global shapes of the cache leaves a decode step
# moved (redistributed to other placements)
SEEN = {"wkv": set(), "tm": set(), "parts": set(), "moved": set(), "watch": False}
_mix, _part, _redistribute = ops.rwkv6_mix, layers.decode_attention_part, DTensor.redistribute
_timemix, _gather_seq = rwkv.timemix_apply, distributed.gather_seq


def mix_probe(r, k, v, w, u, init_state=None, impl=None):
    SEEN["wkv"].add((r.shape[2], u.shape[0], -1 if init_state is None else init_state.shape[1]))
    return _mix(r, k, v, w, u, init_state=init_state, impl=impl)


def timemix_probe(params, x, cfg, *, cache=None):
    SEEN["tm"].add(tuple(tuple(params[n].shape) for n in ("wr", "wk", "wv", "wg", "wo")))
    return _timemix(params, x, cfg, cache=cache)


def part_probe(q, k, v, valid_len, kv_offset, window=None):
    SEEN["parts"].add((q.shape[2], k.shape[2], k.shape[1], kv_offset,
                       valid_len == kv_offset + k.shape[1]))
    return _part(q, k, v, valid_len, kv_offset, window)


def redistribute_probe(self, *args, **kwargs):
    placements = kwargs.get("placements", args[1] if len(args) > 1 else None)
    if SEEN["watch"] and placements is not None and tuple(placements) != tuple(self.placements):
        SEEN["moved"].add(tuple(self.shape))
    return _redistribute(self, *args, **kwargs)


ops.rwkv6_mix, layers.decode_attention_part = mix_probe, part_probe
rwkv.timemix_apply = timemix_probe
DTensor.redistribute = redistribute_probe


def load(tmp, name):
    return dict(np.load(f"{tmp}/{name}.npz"))


def model_of(cfg, sd):
    m = build_model(cfg).init(device="meta").to_empty(device="cpu")
    m.load_state_dict(sd)
    return m


def train(tmp, arch, devices, model):
    ref = load(tmp, f"{arch}_{devices}x{model}")
    cfg = get_config(arch, reduced=True)
    sd = params_from_jax(nest(load(tmp, f"serve_{arch}"), "init/"))
    batches = []
    for i in range(int(ref["losses"].shape[0])):
        b = nest(ref, f"batch{i}/")
        batches.append({**{k: torch.from_numpy(v) for k, v in b.items() if k != "ascent"},
                        "ascent": {k: torch.from_numpy(v) for k, v in b["ascent"].items()}})
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)
    mesh = make_sized_mesh(devices, model)

    def run_steps():
        ex = FusedExecutor(build_model(cfg).loss_fn, mcfg, optim.sgd(LR[arch], momentum=0.9),
                           mesh=mesh, model_cfg=cfg)
        state, losses = ex.init_state(model_of(cfg, sd), 1), []
        for b in batches:
            state, m = ex.step(state, b)
            losses.append(float(m["loss"]))
        full = {k: distributed.gather(v) for k, v in state.params.items()}
        return {"losses": losses, "params": to_reference(full, leaf=lambda t: t.numpy())}

    SEEN["wkv"].clear()
    SEEN["tm"].clear()
    out = run_steps()
    out["wkv"], out["tm"] = sorted(SEEN["wkv"]), sorted(SEEN["tm"])
    if (arch, model) == ("rwkv6-7b", 2):
        # the control: the time mix's partial leaves averaged over dp only,
        # their gradients not summed over the model group
        partitioning.tp_leaves = lambda part, leaves, cfg, lay: (
            _tp_leaves(part, leaves, cfg, lay)[0], ())
        out["control"] = run_steps()
        partitioning.tp_leaves = _tp_leaves
    if (arch, model) == ("rwkv6-7b", 8):
        # the control: the column layout's r, k and v all-gathered with the
        # backward of gather_from_model, this rank's slice of its own
        # gradient, not summed over the model group first
        distributed.gather_seq = lambda x, lay, dim=1: distributed.gather_from_model(
            x, lay.model_group, lay.m, lay.r)
        out["control"] = run_steps()
        distributed.gather_seq = _gather_seq
    return out


def serve(tmp, arch, devices, model):
    ref = load(tmp, f"serve_{arch}")
    cfg = get_config(arch, reduced=True)
    mesh = make_sized_mesh(devices, model)
    bundle, whole = build_model(cfg), model_of(cfg, params_from_jax(nest(ref, "init/")))
    named = dict(whole.named_parameters())
    pl = to_placements(state_spec_tree(named, cfg, mesh), mesh)
    placed = {k: distributed.place(v.detach(), mesh.device_mesh, pl[k]) for k, v in named.items()}

    def batch_of(arrays):
        b = {k: torch.from_numpy(v) for k, v in arrays.items()}
        bpl = to_placements(batch_spec_tree(b, mesh), mesh)
        return {k: distributed.place(v, mesh.device_mesh, bpl[k]) for k, v in b.items()}

    for name in ("parts", "wkv", "tm", "moved"):
        SEEN[name].clear()
    pre = {"tokens": ref["prompt"], **({"enc_frames": ref["frames"]} if "frames" in ref else {})}
    served = []
    with torch.no_grad():
        logits, cache = make_prefill_step(bundle, mesh, PAD)(placed, batch_of(pre))
        served.append(logits.numpy())
        decode = make_decode_step(bundle, mesh)
        for fed in ref["fed"]:
            SEEN["watch"] = True
            logits, cache = decode(placed, cache, batch_of({"tokens": fed}))
            SEEN["watch"] = False
            served.append(logits.numpy())
    return {"served": served, "parts": sorted(SEEN["parts"]), "wkv": sorted(SEEN["wkv"]),
            "tm": sorted(SEEN["tm"]), "moved": sorted(SEEN["moved"]),
            "cache": {name: (tuple(t.shape), tuple(t.to_local().shape), str(t.placements))
                      for name, t in cache["layers"].items()},
            "rows": distributed.dp_index(mesh.device_mesh, [0]),
            "r": mesh.device_mesh.get_coordinate()[1]}


def run(rank, world, tmp):
    out = {}
    for a, d, m in RUNS:
        out[f"{a}_{d}x{m}"] = train(tmp, a, d, m)
        out[f"serve_{a}_{d}x{m}"] = serve(tmp, a, d, m)
    return out


_tp_leaves = partitioning.tp_leaves
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (by npz name) and the port's 8 ranks' results
    (each rank's runs of both archs): each arch's reference subprocess and
    then its spawn of ranks, one arch after the other (never two spawns of
    8 ranks at once beside the suite's other workers)."""
    tmps = {arch: tmp_path_factory.mktemp(f"tp_{arch}") for arch in ARCHS}

    def one(arch):
        tmp, mine = tmps[arch], tuple(t for t in RUNS if t[0] == arch)
        consts = (f"OUT = {str(tmp)!r}\nRUNS = {mine!r}\nARCHS = {(arch,)!r}\nLR = {LR!r}\n"
                  f"PAD = {PAD}\n")
        out = run_py(consts + _REFERENCE, devices=8, timeout=2 * RANK_TIMEOUT_S)
        assert "REFERENCE_OK" in out
        names = [_key(*t) for t in mine] + [f"serve_{arch}"]
        refs = {n: dict(np.load(tmp / f"{n}.npz")) for n in names}
        return refs, spawn_ranks(tmp, consts + _RANKS, timeout=3 * RANK_TIMEOUT_S)

    done = [one(arch) for arch in ARCHS]
    refs = {k: v for r, _ in done for k, v in r.items()}
    ranks = [{k: v for _, per_rank in done for k, v in per_rank[i].items()}
             for i in range(len(done[0][1]))]
    return refs, ranks


def _within(got, want) -> bool:
    return np.allclose(got, want, rtol=2e-5, atol=1e-6)


def _final(ref) -> dict:
    return {k[len("final/"):]: v for k, v in ref.items() if k.startswith("final/")}


@pytest.mark.parametrize("arch,devices,model", RUNS)
def test_tp_async_sam_matches_the_reference(runs, arch, devices, model):
    """4 SGD-momentum AsyncSAM steps in the "tp" layout (rwkv6 at lr 3e-5:
    its time mix on 2, 1 and (not dividing 8) all 4 of its heads a rank,
    its channel mix on 112, 56 and 28 of its 224 d_ff; whisper on (8, 2)
    everything split, on (8, 8) its 4 heads whole and its MLP and
    vocabulary split): the losses on every rank, and every parameter after
    the steps, hold to the reference's sharded run at rtol 2e-5, atol
    1e-6."""
    refs, ranks = runs
    key = _key(arch, devices, model)
    ref, r0 = refs[key], ranks[0][key]
    for r in ranks[1:]:
        assert r[key]["losses"] == r0["losses"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-5, atol=1e-6)
    got, want = _flat(r0["params"]), _final(ref)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("model", (2, 4, 8))
def test_wkv_runs_on_the_ranks_heads(runs, model):
    """Every rank's time mix got `wr`, `wk`, `wv` and `wg` at d_model / m of
    their 64 columns and `wo` at 64 / m rows, none gathered over "model",
    in training and in serving; on (8, 8), which its 4 heads do not
    divide, that is 8 columns, half a head (the column layout). The wkv
    wrapper got H/m of the 4 heads (r, u and, in decode, the carried
    state: 2 on (8, 2), 1 on (8, 4)); on (8, 8) all 4, fed by the gathered
    columns. The serve step's cache holds each rank's heads of the wkv
    state (its placement Shard(2) over "model"), on (8, 8) every head
    (replicated over "model", whose 8 ranks then move none of it: the
    placement it is computed in differs only over the 1-rank "data" axis).
    Where it is split no decode step moves it: of the cache the steps
    redistribute only the token shifts (L, B, 1, D), a token wide (the
    other moves are the weights' gathers and the batch's)."""
    from repro_torch.configs import get_config
    _, ranks = runs
    cfg = get_config("rwkv6-7b", reduced=True)
    d, heads = cfg.d_model, cfg.d_model // cfg.rwkv.head_dim
    h = heads // model if heads % model == 0 else heads
    shards = [((d, d // model),) * 4 + ((d // model, d),)]
    for r in ranks:
        assert r[_key("rwkv6-7b", 8, model)]["wkv"] == [(h, h, -1)]
        assert r[_key("rwkv6-7b", 8, model)]["tm"] == shards
        s = r[f"serve_{_key('rwkv6-7b', 8, model)}"]
        assert s["tm"] == shards
        assert s["wkv"] == [(h, h, -1), (h, h, h)]
        shape, local, placements = s["cache"]["wkv"]
        assert local[2] == h and shape[2] == heads
        if h == heads:
            assert placements == "(Shard(dim=1), Replicate())", placements
            continue
        assert placements == "(Shard(dim=1), Shard(dim=2))", placements
        assert shape not in [tuple(m) for m in s["moved"]]
        assert (2, 8, 1, cfg.d_model) in [tuple(m) for m in s["moved"]]


def test_partial_leaves_not_summed_miss_the_reference(runs):
    """The control: rwkv6 on (8, 2) with the time mix's and channel mix's
    partial leaves (the mixes, the decay's LoRA, w0, the bonus, the norm
    scale: each rank's gradient is its heads' or columns' part) averaged
    over dp alone, not summed over the model group, misses the reference's
    parameters, the time mix's partial leaves among them."""
    refs, ranks = runs
    key = _key("rwkv6-7b", 8, 2)
    got, want = _flat(ranks[0][key]["control"]["params"]), _final(refs[key])
    missed = [k for k in want if not _within(got[k], want[k])]
    assert "blocks/tm/bonus_u" in missed and "blocks/tm/decay_b" in missed, missed


def test_gathered_columns_not_summed_miss_the_reference(runs):
    """The control: rwkv6 on (8, 8) in the column layout with r, k and v
    all-gathered by `gather_from_model`, whose backward hands each rank its
    slice of its own gradient of the whole r, k and v where the ranks'
    gradients must first be summed (each rank's scan feeds only its
    columns of y), misses the reference's parameters, wr, wk and wv among
    them."""
    refs, ranks = runs
    key = _key("rwkv6-7b", 8, 8)
    got, want = _flat(ranks[0][key]["control"]["params"]), _final(refs[key])
    missed = [k for k in want if not _within(got[k], want[k])]
    assert {"blocks/tm/wr", "blocks/tm/wk", "blocks/tm/wv"} <= set(missed), missed


@pytest.mark.parametrize("arch,devices,model", RUNS)
def test_tp_prefill_decode_match_the_reference(runs, arch, devices, model):
    """Prefill of 8 prompts of 24 (whisper: with 24 encoder frames) into a
    cache of 32 and 4 decode steps on given tokens, params and batch placed
    over the mesh: each rank's rows of the logits hold to the reference's
    meshless run at 1e-4 of their scale."""
    refs, ranks = runs
    ref = refs[f"serve_{arch}"]
    for r in ranks:
        a = r[f"serve_{_key(arch, devices, model)}"]
        idx, n = a["rows"]
        rows = slice(idx * 8 // n, (idx + 1) * 8 // n)
        for step, got in enumerate(a["served"]):
            want = ref["served"][step][rows]
            assert np.abs(got - want).max() <= 1e-4 * float(np.abs(want).max()), (arch, step)


def test_whisper_decode_parts_and_caches(runs):
    """whisper on (8, 2) keeps its self and cross k/v on their kv heads (2
    of 4 a rank) and decodes with no block parts, moving no k/v; on (8, 8),
    whose model axis its 4 heads do not divide, both stay on 8 sequence
    blocks (self 32 / 8, cross 24 / 8): each rank attends with every head
    over its block of each, the cross block every position valid, and the
    parts are combined. No decode step moves a k/v leaf (L, B, S, K, hd)
    on either mesh."""
    _, ranks = runs
    for r in ranks:
        a = r[f"serve_{_key('whisper-tiny', 8, 2)}"]
        assert a["parts"] == []
        for name in ("k", "v", "cross_k", "cross_v"):
            shape, local, placements = a["cache"][name]
            assert local[3] * 2 == shape[3] == 4, (name, shape, local)
        assert [m for m in a["moved"] if len(m) == 5] == [], a["moved"]
        b = r[f"serve_{_key('whisper-tiny', 8, 8)}"]
        cross = [p for p in b["parts"] if p[2] == PROMPT // 8]
        assert cross == [(4, 4, PROMPT // 8, PROMPT // 8 * b["r"], True)], b["parts"]
        assert {p[:4] for p in b["parts"] if p not in cross} == {
            (4, 4, PAD // 8, PAD // 8 * b["r"])}, b["parts"]
        for name, n in (("k", PAD), ("cross_k", PROMPT)):
            shape, local, placements = b["cache"][name]
            assert local[2] * 8 == shape[2] == n, (name, shape, local)
        assert [m for m in b["moved"] if len(m) == 5] == [], b["moved"]


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------

def _rwkv_layer(seed=0):
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv
    cfg = get_config("rwkv6-7b", reduced=True)
    gen = torch.Generator().manual_seed(seed)

    def init(shapes):   # std 1 / sqrt(fan-in) for matrices, N(0, 1) x 0.3 else
        return {k: (torch.randn(s, generator=gen) * (s[-2] ** -0.5 if len(s) == 2 else 0.3)
                    ).requires_grad_() for k, s in shapes.items()}

    tm, cm = init(rwkv.timemix_shapes(cfg)), init(rwkv.channelmix_shapes(cfg))
    with torch.no_grad():
        tm["w0"].sub_(2.0)
    x = torch.randn(3, 16, cfg.d_model, generator=gen).requires_grad_()
    w = torch.randn(3, 16, cfg.d_model, generator=gen)
    return cfg, tm, cm, x, w


def _timemix_shares(tm, x, cfg, m, shift, wkv):
    """The m time-mix shares of `partitioning.rwkv_share` composed without
    collectives: (their outputs' sum, the wkv state). Where m divides the
    heads, `timemix_part` of each share's heads from its heads' state, the
    states stacked on the heads; else the column layout's pieces: each
    share's `timemix_project` on its d_model / m columns, r, k and v joined
    whole (autograd sums the shares' gradients of them, as the reduce-
    scatter of f after the all-gather does), `timemix_scan` on every head
    from the whole state on each share, and `timemix_gate_out` of its
    columns through its rows of wo; every share's state is the whole."""
    from repro_torch.models import partitioning, rwkv
    heads = cfg.d_model // cfg.rwkv.head_dim
    shares = [partitioning.rwkv_share("tm", tm, r, m) for r in range(m)]
    if heads % m == 0:
        h = heads // m
        parts = [rwkv.timemix_part(shares[r], x, cfg, r, m,
                                   cache={"shift": shift, "wkv": wkv[:, r * h:(r + 1) * h]})
                 for r in range(m)]
        return sum(p[0] for p in parts), torch.cat([p[1]["wkv"] for p in parts], dim=1)
    w = cfg.d_model // m
    pieces = [rwkv.timemix_project(sh, x, cfg, cache={"shift": shift}) for sh in shares]
    rr, kk, vv = (torch.cat([p[c] for p in pieces], dim=-1) for c in "rkv")
    total, states = 0, []
    for r, (sh, p) in enumerate(zip(shares, pieces)):
        y, st = rwkv.timemix_scan(sh, rr, kk, vv, p["xw"], cfg, cache={"shift": shift, "wkv": wkv})
        total = total + rwkv.timemix_gate_out(sh, y[..., r * w:(r + 1) * w], p["g"], cfg, r * w,
                                              (r + 1) * w)
        states.append(st)
    for st in states[1:]:
        torch.testing.assert_close(st, states[0], rtol=0, atol=0)
    return total, states[0]


@pytest.mark.parametrize("m", (2, 4, 8))
def test_rwkv_shares_sum_to_the_whole_layer(m):
    """The m time-mix shares of the whole weights (`_timemix_shares`: on 2
    and 4 the heads' parts, each from the carried shift and its heads' wkv
    state; on 8, which the 4 heads do not divide, the column pieces, half a
    head a share) sum to the whole `timemix_apply` and their state is its
    state; the channel mix's m values (`channel_value` on its
    `rwkv_share`) summed, gated on each share's columns (`channel_gate`)
    and joined, are the whole `channelmix_apply`: forward and the
    gradients of x and every leaf, fp32 at 2e-5."""
    from repro_torch.models import partitioning, rwkv
    cfg, tm, cm, x, w = _rwkv_layer()
    b, d = x.shape[0], cfg.d_model
    heads = d // cfg.rwkv.head_dim
    gen = torch.Generator().manual_seed(1)
    shift = torch.randn(b, 1, d, generator=gen)
    wkv = torch.randn(b, heads, cfg.rwkv.head_dim, cfg.rwkv.head_dim, generator=gen) * 0.1
    y_t, c_t = rwkv.timemix_apply(tm, x, cfg, cache={"shift": shift, "wkv": wkv})
    y_c, _ = rwkv.channelmix_apply(cm, x, cfg, cache={"shift": shift})
    leaves = [x, *tm.values(), *cm.values()]
    want = torch.autograd.grad(((y_t + y_c) * w).sum(), leaves)

    total_t, state = _timemix_shares(tm, x, cfg, m, shift, wkv)
    prev = torch.cat([shift, x[:, :-1]], dim=1)
    xk = x + (prev - x) * cm["mix_k"]
    xr = x + (prev - x) * cm["mix_r"]
    v = sum(rwkv.channel_value(partitioning.rwkv_share("cm", cm, r, m), xk, cfg) for r in range(m))
    total_c = torch.cat([rwkv.channel_gate(partitioning.rwkv_share("cm", cm, r, m), xr,
                                           v[..., r * d // m:(r + 1) * d // m], cfg)
                         for r in range(m)], dim=-1)
    got = torch.autograd.grad(((total_t + total_c) * w).sum(), leaves)
    torch.testing.assert_close(total_t, y_t, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(total_c, y_c, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(state, c_t["wkv"], rtol=2e-5, atol=2e-5)
    for g, g_want in zip(got, want):
        torch.testing.assert_close(g, g_want, rtol=2e-5, atol=2e-5)


def test_cross_decode_blocks_merge_to_the_whole_decode():
    """Decode's cross-attention over cross k/v of 24 positions in 8 blocks
    of 3, every position valid (`layers.decode_attention_part` of each
    block up to its end, merged by `distributed.lse_merge`, as
    `layers.decode_blocks` combines them over the ranks), matches
    `ops.decode_attention` over the whole at 1e-5 in fp32."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.utils import distributed
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(3, 1, 6, 64, generator=gen)
    k, v = (torch.randn(3, 24, 6, 64, generator=gen) for _ in range(2))
    parts = [layers.decode_attention_part(q, k[:, i:i + 3], v[:, i:i + 3], i + 3, i)
             for i in range(0, 24, 3)]
    out = distributed.lse_merge(*(torch.stack(t) for t in zip(*parts)))
    b, n_kv, g, sq, hd = out.shape
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, n_kv * g, hd)
    torch.testing.assert_close(out, ops.decode_attention(q, k, v, 24), rtol=1e-5, atol=1e-5)


def _rwkv_tp_lowered(b, s, bp, dp, m, **over):
    """Reduced rwkv6's AsyncSAM step traced on fake tensors over a fake
    (data dp, model m) mesh, batch b x s (b' bp) placed over "data"; `over`
    replaces fields of its config."""
    from repro_torch.configs import get_config
    from repro_torch.core import MethodConfig
    from repro_torch.engine import FusedExecutor
    from repro_torch.kernels import flat
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.launch.sharding import batch_spec_tree
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import make_optimizer
    from repro_torch.utils import abstract

    cfg = dataclasses.replace(get_config("rwkv6-7b", reduced=True), **over)
    bundle = build_model(cfg)
    with fake_world(dp * m), flat.trace_kernels():
        mesh = make_host_mesh(model_axis=m, device="cpu")
        ex = FusedExecutor(bundle.loss_fn, MethodConfig(name="async_sam"),
                           make_optimizer("adamw", 1e-3, clip_norm=1.0), mesh=mesh,
                           model_cfg=cfg)
        state = ex.abstract_state(lambda: bundle.init(seed=0, device="cpu"), seed=1)
        with abstract.fake_mode_of(state):
            batch = dryrun.batch_spec(cfg, ShapeSpec("t", "train", s, b), ascent_fraction=0.25,
                                      device="cpu")
            batch = dryrun.place_tree(batch, batch_spec_tree(batch, mesh), mesh)
        return cfg, ex.lower(state, batch)


def _scan_flops(cfg, rows, s, heads) -> int:
    """Both wkv kernels' formulas on `heads` heads of rows x s, every layer."""
    from repro_torch.kernels import rwkv6_scan as r6
    shape = (rows, s, heads, cfg.rwkv.head_dim)
    return cfg.n_layers * (r6._fwd_flops(shape, shape, shape) + r6._bwd_flops(shape, shape, shape))


def test_rwkv_tp_train_step_flops_by_hand():
    """Reduced rwkv6 traced on fake tensors over a fake (data 2, model 2)
    mesh, batch 8 x 64 (b' 2) placed over "data": rank 0 computes its dp
    half of the rows, the time mix on 2 of the 4 heads, the channel mix on
    half the d_ff and half of wr_c's columns, and half the vocabulary. Its
    flops, backward twice forward: r, k, v, g and o (5 d^2 / 2 a token), the
    decay's LoRA (d R whole, R d / 2), the channel mix (2 d f / 2 + d^2 /
    2), the logits (d V / 2); the wkv kernels' formulas on 2 heads. The
    reduce-scatter of the channel mix's value is in the collectives."""
    b, s, bp, m, dp = 8, 64, 2, 2, 2
    cfg, lowered = _rwkv_tp_lowered(b, s, bp, dp, m)
    d, f, v, L, rank = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers, cfg.rwkv.decay_lora_rank
    rows = (b + bp) // dp
    tokens = rows * s
    per_layer = 5 * d * d // m + d * rank + rank * d // m + 2 * d * f // m + d * d // m
    dense = 3 * 2 * tokens * (L * per_layer + d * v // m)
    assert lowered.kernels["rwkv6_scan_fwd"] == 2 * L
    assert lowered.flops == dense + _scan_flops(cfg, rows, s, d // cfg.rwkv.head_dim // m)
    kinds = {(c["kind"], c["group"]) for c in lowered.collectives}
    assert ("reduce-scatter", m) in kinds, sorted(kinds)


def test_weight_stream_bf16_gathers_move_bf16():
    """`weight_stream_bf16` under a mesh: reduced rwkv6 (bf16 compute)
    traced on a fake (data 2, model 1) mesh with the option and without.
    The same collectives run in the same order; every all-gather of a
    block's d x d or d x d_ff matrix moves half the bytes (the cast comes
    before the gather), and nothing else changes (the gradients'
    all-reduces stay fp32, `distributed.gather_for_compute`)."""
    runs = {ws: _rwkv_tp_lowered(2, 32, 1, 2, 1, compute_dtype="bfloat16",
                                 weight_stream_bf16=ws) for ws in (False, True)}
    cfg = runs[False][0]
    off, on = ([(c["kind"], c["group"], c["bytes"]) for c in runs[ws][1].collectives]
               for ws in (False, True))
    mats = {4 * cfg.d_model * cfg.d_model, 4 * cfg.d_model * cfg.d_ff}
    assert len(off) == len(on)
    halved = [a for a, b in zip(off, on) if a != b]
    assert halved and all(b == (a[0], a[1], a[2] // 2) for a, b in zip(off, on) if a != b)
    assert {a[2] for a in halved} == mats
    assert halved == [a for a in off if a[0] == "all-gather" and a[2] in mats]


def test_rwkv_tp_column_layout_flops_by_hand():
    """Reduced rwkv6 traced on fake tensors over a fake (data 1, model 8)
    mesh, whose model axis its 4 heads do not divide, batch 2 x 64 (b' 1):
    rank 0 computes the time mix on its 8 of the 64 columns (r, k, v, g and
    o: 5 d^2 / 8 a token), the decay's LoRA whole (2 d R: every rank takes
    the log decay of every head), the channel mix on 28 of the 224 d_ff and
    8 of wr_c's columns, and 32 of the 256 logits; backward twice forward;
    the wkv kernels' formulas on all 4 heads. r, k and v all-gathered over
    the 8 ranks (and the gradient reduce-scattered back) are among the
    collectives."""
    b, s, bp, m, dp = 2, 64, 1, 8, 1
    cfg, lowered = _rwkv_tp_lowered(b, s, bp, dp, m)
    d, f, v, L, rank = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers, cfg.rwkv.decay_lora_rank
    tokens = (b + bp) * s
    per_layer = 5 * d * d // m + 2 * d * rank + 2 * d * f // m + d * d // m
    dense = 3 * 2 * tokens * (L * per_layer + d * v // m)
    assert lowered.kernels["rwkv6_scan_fwd"] == 2 * L
    assert lowered.flops == dense + _scan_flops(cfg, b + bp, s, d // cfg.rwkv.head_dim)
    kinds = {(c["kind"], c["group"]) for c in lowered.collectives}
    assert {("all-gather", m), ("reduce-scatter", m)} <= kinds, sorted(kinds)
