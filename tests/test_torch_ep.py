"""The reference's MoE and MLA layouts in the port (`models.moe`,
`models.mla`, `models.partitioning`): the experts over "model" (EP where
"model" divides the expert count, else expert TP over their d_ff), MLA on
its heads, and the "tp" serve step's decode over a cache's sequence blocks
where the kv heads cannot carry it, on a world of CPU ranks (gloo).

One reference subprocess (8 fake CPU devices, `tests/conftest.py:run_py`)
runs the reference's 4 sharded AsyncSAM steps of reduced mixtral-8x7b and
deepseek-v2-lite-16b on `make_sized_mesh(8, 2)` (EP: 2 and 4 experts a
rank; deepseek's MLA on 2 of its 4 heads a rank) and of reduced mixtral on
`make_sized_mesh(8, 8)` (4 experts on 8: expert TP over 16 of 128
columns), and its meshless prefill and decode of reduced mixtral, gemma-2b
and deepseek; one spawn of 8 gloo ranks (`test_torch_distributed.
spawn_ranks`) runs the port's on the same init and batches, with probes on
the routing, the expert shares and the decode parts. In process: the m
shares of `moe_share` against the whole `moe_apply`, the pure combine of
decode parts (`distributed.lse_merge`) against the whole decode, and a
fake-tensor trace on a (data 2, model 2) fake mesh whose expert flops are
counted by hand.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import run_py
from test_torch_distributed import RANK_TIMEOUT_S, _flat, spawn_ranks

# (arch, devices, model axis) of each sharded training run
TRAIN = (("mixtral-8x7b", 8, 2), ("deepseek-v2-lite-16b", 8, 2), ("mixtral-8x7b", 8, 8))
SERVE = ("mixtral-8x7b", "gemma-2b", "deepseek-v2-lite-16b")
STEPS, PROMPT, PAD, N_DEC = 4, 40, 64, 4
SERVE_MESH = (8, 4)   # 4 blocks of 16 positions: no kv head count here divides 4


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

for arch, devices, model in TRAIN:
    cfg = get_config(arch, reduced=True)
    bundle = build_model(cfg)
    params = bundle.init(jax.random.PRNGKey(0))
    batches = [synth_batch(cfg, 8, 16, jax.random.PRNGKey(i), 0.5) for i in range({STEPS})]
    out = {{}}
    tree_map_with_path(lambda p, x: out.__setitem__("init/" + p, np.asarray(x)), params)
    for i, b in enumerate(batches):
        tree_map_with_path(lambda p, x: out.__setitem__(f"batch{{i}}/" + p, np.asarray(x)), b)
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)
    ex = FusedExecutor(bundle.loss_fn, mcfg, optim.sgd(1e-2, momentum=0.9),
                       mesh=make_sized_mesh(devices, model), model_cfg=cfg)
    state = ex.init_state(params, jax.random.PRNGKey(1))
    losses, aux = [], []
    for b in batches:
        state, m = ex.step(state, b)
        losses.append(float(m["loss"]))
        aux.append(float(m["moe_aux"]))
    out["losses"], out["moe_aux"] = np.asarray(losses), np.asarray(aux)
    tree_map_with_path(lambda p, x: out.__setitem__("final/" + p, np.asarray(x)),
                       jax.device_get(state.params))
    np.savez(f"{{OUT}}/{{arch}}_{{devices}}x{{model}}.npz", **out)

for arch in SERVE:
    cfg = get_config(arch, reduced=True)
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
    np.savez(f"{{OUT}}/serve_{{arch}}.npz", **out)
print("REFERENCE_OK")
'''

_RANKS = '''
import dataclasses, hashlib
import numpy as np
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.engine import FusedExecutor
from repro_torch.launch.sharding import batch_spec_tree, state_spec_tree, to_placements
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model, layers, mla, moe, partitioning, transformer
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


# the routing each call computed (a digest of its bits), the expert shares'
# shapes the model handed over, and the decode parts' (query heads, block)
SEEN = {"routes": [], "shares": set(), "parts": set()}
_routing, _share = moe.make_routing, moe.moe_share
_part, _mla_part = layers.decode_attention_part, mla.absorbed_decode_part


def routing_probe(router, x, cfg):
    rt = _routing(router, x, cfg)
    bits = b"".join(t.detach().contiguous().numpy().tobytes() for t in rt)
    SEEN["routes"].append(hashlib.sha1(bits).hexdigest())
    return rt


def share_probe(params, x, cfg, r=0, m=1, routing=None):
    SEEN["shares"].add((tuple(params["we_in"].shape), tuple(params["we_out"].shape), r, m))
    return _share(params, x, cfg, r, m, routing)


def part_probe(q, k, v, valid_len, kv_offset, window=None):
    SEEN["parts"].add(("gqa", q.shape[2], k.shape[2], k.shape[1], kv_offset))
    return _part(q, k, v, valid_len, kv_offset, window)


def mla_part_probe(q_lat, q_rope, c_kv, k_rope, valid_len, kv_offset, cfg):
    SEEN["parts"].add(("mla", q_lat.shape[2], 0, c_kv.shape[1], kv_offset))
    return _mla_part(q_lat, q_rope, c_kv, k_rope, valid_len, kv_offset, cfg)


moe.make_routing, moe.moe_share = routing_probe, share_probe
layers.decode_attention_part, mla.absorbed_decode_part = part_probe, mla_part_probe


def load(tmp, name):
    return dict(np.load(f"{tmp}/{name}.npz"))


def model_of(cfg, sd):
    m = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    m.load_state_dict(sd)
    return m


def train(tmp, arch, devices, model):
    ref = load(tmp, f"{arch}_{devices}x{model}")
    cfg = get_config(arch, reduced=True)
    sd = params_from_jax(nest(ref, "init/"))
    batches = []
    for i in range(int(ref["losses"].shape[0])):
        b = nest(ref, f"batch{i}/")
        batches.append({**{k: torch.from_numpy(v) for k, v in b.items() if k != "ascent"},
                        "ascent": {k: torch.from_numpy(v) for k, v in b["ascent"].items()}})
    mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)
    mesh = make_sized_mesh(devices, model)

    def run_steps():
        ex = FusedExecutor(build_model(cfg).loss_fn, mcfg, optim.sgd(1e-2, momentum=0.9),
                           mesh=mesh, model_cfg=cfg)
        state, losses, aux = ex.init_state(model_of(cfg, sd), 1), [], []
        for b in batches:
            state, m = ex.step(state, b)
            losses.append(float(m["loss"]))
            aux.append(float(m["moe_aux"]))
        return state, losses, aux

    SEEN["routes"].clear(), SEEN["shares"].clear()
    state, losses, aux = run_steps()
    full = {k: distributed.gather(v) for k, v in state.params.items()}
    out = {"losses": losses, "moe_aux": aux, "routes": list(SEEN["routes"]),
           "shares": sorted(SEEN["shares"]),
           "params": to_reference(full, leaf=lambda t: t.numpy()),
           "rows": distributed.dp_index(mesh.device_mesh, [0])}
    # each rank's gathered expert weights are its share of the whole
    part = {name: state.params[f"blocks.0.moe.{name}"]
            for name in ("router", "we_in", "we_gate", "we_out")}
    whole = {name: full[f"blocks.0.moe.{name}"] for name in part}
    with torch.no_grad(), partitioning.activation_sharding(mesh):
        lay = partitioning.current_layout()
        got = partitioning.gather_part("moe", part, cfg)
        want = moe.expert_share(whole, cfg, lay.r, lay.m)
        out["share_exact"] = all(torch.equal(got[n], want[n]) for n in part)
    if (arch, model) == ("mixtral-8x7b", 2):
        # the control: the model group sums the aux's gradient m times
        distributed.scale_grad = lambda t, s: t
        state, losses, aux = run_steps()
        distributed.scale_grad = _scale_grad
        full = {k: distributed.gather(v) for k, v in state.params.items()}
        out["control"] = {"losses": losses, "moe_aux": aux,
                          "params": to_reference(full, leaf=lambda t: t.numpy())}
    return out


def serve(tmp, arch):
    ref = load(tmp, f"serve_{arch}")
    cfg = get_config(arch, reduced=True)
    mesh = make_sized_mesh(*SERVE_MESH)
    bundle, whole = build_model(cfg), model_of(cfg, params_from_jax(nest(ref, "init/")))
    named = dict(whole.named_parameters())
    pl = to_placements(state_spec_tree(named, cfg, mesh), mesh)
    placed = {k: distributed.place(v.detach(), mesh.device_mesh, pl[k]) for k, v in named.items()}

    def batch_of(tokens):
        t = torch.from_numpy(tokens)
        return {"tokens": distributed.place(t, mesh.device_mesh,
                                            to_placements(batch_spec_tree({"tokens": t}, mesh),
                                                          mesh)["tokens"])}

    SEEN["parts"].clear()
    served = []
    with torch.no_grad():
        logits, cache = make_prefill_step(bundle, mesh, PAD)(placed, batch_of(ref["prompt"]))
        served.append(logits.numpy())
        decode = make_decode_step(bundle, mesh)
        for fed in ref["fed"]:
            logits, cache = decode(placed, cache, batch_of(fed))
            served.append(logits.numpy())
    leaf = cache["layers"]["c_kv" if cfg.mla is not None else "k"]
    return {"served": served, "parts": sorted(SEEN["parts"]),
            "cache": (tuple(leaf.shape), tuple(leaf.to_local().shape), str(leaf.placements)),
            "rows": distributed.dp_index(mesh.device_mesh, [0]),
            "r": mesh.device_mesh.get_coordinate()[1]}


def run(rank, world, tmp):
    out = {f"{a}_{d}x{m}": train(tmp, a, d, m) for a, d, m in TRAIN}
    out.update({f"serve_{a}": serve(tmp, a) for a in SERVE})
    return out


_scale_grad = distributed.scale_grad
'''


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """The reference's runs (by npz name) and the port's 8 ranks' results."""
    tmp = tmp_path_factory.mktemp("ep")
    consts = (f"OUT = {str(tmp)!r}\nTRAIN = {TRAIN!r}\nSERVE = {SERVE!r}\n"
              f"SERVE_MESH = {SERVE_MESH!r}\nPAD = {PAD}\n")
    out = run_py(consts + _REFERENCE, devices=8, timeout=2 * RANK_TIMEOUT_S)
    assert "REFERENCE_OK" in out
    names = [_key(*t) for t in TRAIN] + [f"serve_{a}" for a in SERVE]
    refs = {n: dict(np.load(tmp / f"{n}.npz")) for n in names}
    ranks = spawn_ranks(tmp, consts + _RANKS, timeout=3 * RANK_TIMEOUT_S)
    return refs, ranks


def _within(got, want) -> bool:
    return np.allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("arch,devices,model", TRAIN)
def test_ep_async_sam_matches_the_reference(ep_runs, arch, devices, model):
    """4 SGD-momentum AsyncSAM steps with the experts over "model" (EP on
    make_sized_mesh(8, 2): mixtral's 4 experts 2 a rank, deepseek's 8 four a
    rank with its MLA on 2 heads a rank; expert TP on (8, 8): mixtral's 4
    experts on 16 of 128 columns a rank): the losses and `moe_aux` on every
    rank, and every parameter after the steps, hold to the reference's
    sharded run at rtol 2e-5, atol 1e-6."""
    refs, ranks = ep_runs
    key = _key(arch, devices, model)
    ref, r0 = refs[key], ranks[0][key]
    for r in ranks[1:]:
        assert r[key]["losses"] == r0["losses"] and r[key]["moe_aux"] == r0["moe_aux"]
    assert min(r0["moe_aux"]) > 0
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(r0["moe_aux"], ref["moe_aux"], rtol=2e-5, atol=1e-6)
    got = _flat(r0["params"])
    want = {k[len("final/"):]: v for k, v in ref.items() if k.startswith("final/")}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch,devices,model", TRAIN)
def test_ep_ranks_hold_their_share_and_route_alike(ep_runs, arch, devices, model):
    """The same runs' probes: every `moe_share` call on rank r got r's
    share of the expert weights (EP: (E/m, d, f); expert TP: (E, d, f/m)
    and (E, f/m, d)), the gathered leaves equal to `moe.expert_share` of the
    whole; and the ranks of one model group (one dp index) routed every
    call from the same bits."""
    from repro_torch.configs import get_config
    _, ranks = ep_runs
    key = _key(arch, devices, model)
    moe = get_config(arch, reduced=True).moe
    e, d, f = moe.n_experts, get_config(arch, reduced=True).d_model, moe.expert_d_ff
    by_row = {}
    for rank, r in enumerate(ranks):
        a = r[key]
        coord = rank % model
        if e % model == 0:
            want = ((e // model, d, f), (e // model, f, d), coord, model)
        else:
            want = ((e, d, f // model), (e, f // model, d), coord, model)
        assert a["shares"] == [want], a["shares"]
        assert a["share_exact"]
        assert a["routes"]
        by_row.setdefault(a["rows"], []).append(a["routes"])
    for routes in by_row.values():
        assert all(x == routes[0] for x in routes[1:])


def test_ep_aux_counted_m_times_misses_the_reference(ep_runs):
    """The control: mixtral on (8, 2) with the aux's gradient taken whole on
    both model ranks (`distributed.scale_grad` the identity), so that the
    model group's sum counts it twice, misses the reference's run: its
    values are the same, its parameters are not."""
    refs, ranks = ep_runs
    key = _key("mixtral-8x7b", 8, 2)
    ref, c = refs[key], ranks[0][key]["control"]
    np.testing.assert_allclose(c["moe_aux"][0], ref["moe_aux"][0], rtol=2e-5, atol=1e-6)
    got = _flat(c["params"])
    want = {k[len("final/"):]: v for k, v in ref.items() if k.startswith("final/")}
    assert not all(_within(got[k], want[k]) for k in want)
    assert not _within(got["blocks/moe/router"], want["blocks/moe/router"])


# the decode parts each rank computed: (kind, query heads, kv heads, block
# length, the block's offset); every query head over the rank's block of 16
PARTS = {"mixtral-8x7b": ("gqa", 4, 2), "gemma-2b": ("gqa", 4, 1),
         "deepseek-v2-lite-16b": ("mla", 4, 0)}


@pytest.mark.parametrize("arch", SERVE)
def test_tp_decode_over_cache_blocks_matches_the_reference(ep_runs, arch):
    """Prefill of 8 prompts of 40 into a cache of 64 and 4 decode steps on
    given tokens, params and batch placed over make_sized_mesh(8, 4), whose
    "model" axis no kv head count here divides (mixtral 2, gemma 1, MLA's
    latents): the cache stays on 4 sequence blocks of 16 (each rank's
    block, the batch over "data"), every rank attends with every query head
    over its block and the parts are combined; mixtral's window of 8 leaves
    three of the four blocks with no key at every decode step. Each rank's
    rows of the logits hold to the reference's meshless run at 1e-4 of
    their scale."""
    refs, ranks = ep_runs
    ref = refs[f"serve_{arch}"]
    kind, heads, kv = PARTS[arch]
    for r in ranks:
        a = r[f"serve_{arch}"]
        idx, n = a["rows"]
        rows = slice(idx * 8 // n, (idx + 1) * 8 // n)
        for step, got in enumerate(a["served"]):
            want = ref["served"][step][rows]
            assert np.abs(got - want).max() <= 1e-4 * float(np.abs(want).max()), (arch, step)
        assert a["parts"] == [(kind, heads, kv, PAD // 4, 16 * a["r"])], a["parts"]
        shape, local, placements = a["cache"]
        assert placements == "(Shard(dim=1), Shard(dim=2))", placements
        assert local[1] * 2 == shape[1] and local[2] * 4 == shape[2] == PAD


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------

def _moe_layer(arch, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch, reduced=True)
    gen = torch.Generator().manual_seed(seed)

    def init(shapes):   # the models' scale: std 1 / sqrt(fan-in)
        return {k: (torch.randn(s, generator=gen) * s[-2] ** -0.5).requires_grad_()
                for k, s in shapes.items()}

    params = init(moe.moe_shapes(cfg))
    if cfg.moe.n_shared_experts:
        params["shared"] = init(moe.shared_shapes(cfg))
    x = torch.randn(3, 16, cfg.d_model, generator=gen).requires_grad_()
    w = torch.randn(3, 16, cfg.d_model, generator=gen)
    return cfg, params, x, w


def _merge(parts):
    """`distributed.lse_merge` of a list of (m, l, o) parts."""
    from repro_torch.utils import distributed
    return distributed.lse_merge(*(torch.stack(t) for t in zip(*parts)))


def _leaves(params):
    return [params["router"], params["we_in"], params["we_out"], *(
        [params["shared"]["wi"]] if "shared" in params else [])]


@pytest.mark.parametrize("arch,m", [("mixtral-8x7b", 2), ("mixtral-8x7b", 8),
                                    ("deepseek-v2-lite-16b", 4), ("deepseek-v2-lite-16b", 3)])
def test_moe_shares_sum_to_the_whole_layer(arch, m):
    """The m shares of `moe_share` (EP where m divides the experts: mixtral
    on 2, deepseek on 4; else expert TP: mixtral's 4 experts on 8, deepseek's
    8 on 3), each on `moe.expert_share` of the whole weights, from one
    routing, with the shared experts' d_ff shares, sum to the whole
    `moe_apply` at fp32 2e-5, forward, and the gradients of x, the router,
    we_in, we_out and the shared experts' wi."""
    from repro_torch.models import moe
    cfg, params, x, w = _moe_layer(arch)
    y, aux = moe.moe_apply(params, x, cfg)
    grads = torch.autograd.grad((y * w).sum() + aux, [x, *_leaves(params)])
    rt = moe.make_routing(params["router"], x, cfg)
    total = 0
    for r in range(m):
        share = moe.expert_share(params, cfg, r, m)
        total = total + moe.moe_share(share, x, cfg, r, m, routing=rt)
        if "shared" in share:
            total = total + moe.shared_apply(share["shared"], x, cfg)
    aux_s = moe.aux_loss(rt, cfg)
    got = torch.autograd.grad((total * w).sum() + aux_s, [x, *_leaves(params)])
    torch.testing.assert_close(total, y, rtol=2e-5, atol=2e-5)
    assert float(aux_s.detach()) == float(aux.detach())
    for g, want in zip(got, grads):
        torch.testing.assert_close(g, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window,valid", [(None, 45), (8, 45), (8, 20), (None, 64)])
def test_decode_parts_merge_to_the_whole_decode(window, valid):
    """Decode attention of 2 new positions over a cache of 64 cut into 4
    blocks of 16: each block's (m, l, o) (`layers.decode_attention_part`)
    merged by `distributed.lse_merge` matches `ops.decode_attention` over
    the whole cache at 1e-5 in fp32, GQA 8 / 2 heads; a window of 8 and the
    entries past `valid` leave blocks with no key (l and o zero)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(3, 2, 8, 32, generator=gen)
    k, v = (torch.randn(3, 64, 2, 32, generator=gen) for _ in range(2))
    parts = [layers.decode_attention_part(q, k[:, i:i + 16], v[:, i:i + 16], valid, i,
                                          window=window) for i in range(0, 64, 16)]
    empty = [i for i, (_, l, o) in enumerate(parts) if not l.any()]
    for i in empty:
        assert not parts[i][2].any()
    if window is not None:
        assert empty
    out = _merge(parts)
    b, n_kv, g, sq, hd = out.shape
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, n_kv * g, hd)
    want = ops.decode_attention(q, k, v, valid, window=window)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_absorbed_decode_parts_merge_to_the_whole_decode():
    """MLA's absorbed decode over a latent cache of 64 in 4 blocks
    (`mla.absorbed_decode_part` on each, merged by `distributed.lse_merge`)
    matches `mla_apply`'s whole-cache decode at 1e-5 in fp32, the last
    block past the valid entries."""
    from repro_torch.configs import get_config
    from repro_torch.models import mla
    cfg = get_config("deepseek-v2-lite-16b", reduced=True)
    gen = torch.Generator().manual_seed(4)
    params = {k: torch.randn(s, generator=gen) * 0.3 for k, s in mla.mla_shapes(cfg).items()}
    x = torch.randn(2, 1, cfg.d_model, generator=gen)
    r, rope = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    c_kv, k_rope = torch.randn(2, 64, r, generator=gen), torch.randn(2, 64, rope, generator=gen)
    pos = 40
    positions = torch.full((1, 1), pos)
    want, cache = mla.mla_apply(params, x, cfg, positions=positions,
                                cache={"c_kv": c_kv.clone(), "k_rope": k_rope.clone(), "pos": pos})
    # the same queries and the latent the whole decode wrote, by parts
    q_nope, q_rope = mla._queries(params, x, positions, cfg)
    wuk = params["w_uk"].reshape(r, cfg.n_heads, cfg.mla.qk_nope_head_dim)
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope, wuk)
    parts = [mla.absorbed_decode_part(q_lat, q_rope, cache["c_kv"][:, i:i + 16],
                                      cache["k_rope"][:, i:i + 16], pos + 1, i, cfg)
             for i in range(0, 64, 16)]
    assert not parts[3][1].any()
    o_lat = _merge(parts).transpose(1, 2)
    wuv = params["w_uv"].reshape(r, cfg.n_heads, cfg.mla.v_head_dim)
    out = torch.einsum("bthr,rhv->bthv", o_lat, wuv).reshape(2, 1, -1) @ params["wo"]
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_ep_train_step_flops_by_hand():
    """Reduced mixtral traced on fake tensors over a fake (data 2, model 2)
    mesh, batch 8 x 64 (b' 2) placed over "data": rank 0 computes its dp
    half of the rows, attention on half the heads (4 / 2, its kv heads 2 /
    2), the router whole, 2 of the 4 experts (EP) and half the vocabulary.
    Its flops, backward twice forward: the q, k, v, o projections, the
    router (d E a token), the expert products of its 2 experts over their
    capacity buffers (3 d f for each of E/m * C slots a row), the logits,
    and the flash op on 2 heads with the window of 8 and its plain
    backward."""
    from repro_torch.configs import get_config
    from repro_torch.core import MethodConfig
    from repro_torch.engine import FusedExecutor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flat
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.launch.sharding import batch_spec_tree
    from repro_torch.models import build_model
    from repro_torch.models import moe as MOE
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import make_optimizer
    from repro_torch.utils import abstract

    cfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True), remat="none")
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
    d, v, hd, h, kv, L = (cfg.d_model, cfg.vocab_size, cfg.resolved_head_dim, cfg.n_heads,
                          cfg.n_kv_heads, cfg.n_layers)
    e, f = cfg.moe.n_experts, cfg.moe.expert_d_ff
    rows = (b + bp) // dp
    tokens = rows * s
    attn = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    dense = 3 * tokens * (L * (attn // m + 2 * d * e) + 2 * d * v // m)
    c = MOE._capacity(cfg.moe, s)
    experts = 3 * 2 * L * (e // m) * rows * c * 3 * d * f
    pairs = fa.visible_pairs(s, s, True, cfg.sliding_window)
    flash = 2 * (hd + hd) * (h // m) * pairs * L * rows
    plain_bwd = 3 * 2 * 2 * hd * (h // m) * s * s * L * rows
    assert lowered.kernels["flash_attention_fwd"] == 2 * L
    assert lowered.flops == dense + experts + flash + plain_bwd
