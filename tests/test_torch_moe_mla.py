"""Port parity for `models/moe.py` and `models/mla.py` against the JAX
package's `repro.models.moe` and `repro.models.mla`, on the same weights and
inputs in fp32; and the reference's MoE and MLA property tests
(`tests/test_model_properties.py`) run on the port.

Capacity factors: each MoE test names its own. At 8 no route is dropped; at
0.25 (capacity 4 for a group of 32 tokens, top-2 of 8 experts) most are,
and the port must drop the very routes the reference drops.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.convert import params_from_jax

KEY = jax.random.PRNGKey(0)
F32_REL = 2e-5


def _cf(cfg, capacity_factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=capacity_factor))


def _moe_cfgs(arch, capacity_factor):
    return (_cf(jax_get_config(arch, reduced=True), capacity_factor),
            _cf(get_config(arch, reduced=True), capacity_factor))


def _t(tree) -> dict:
    """A JAX parameter subtree as tensors (nested dicts kept)."""
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _reference_kept(params, x, cfg) -> np.ndarray:
    """The reference's kept (token, slot) routes, (G, S, K) bool, by its own
    lines (`repro/models/moe.py`: top-k of the fp32 softmax, the cumsum
    rank over the token-major, slot-minor flattening, rank < C)."""
    moe = cfg.moe
    B, S, _ = x.shape
    E, K, C = moe.n_experts, moe.top_k, JMOE._capacity(moe, S)
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", x, params["router"]), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    slot_flat = onehot.reshape(B, S * K, E)
    pos = (jnp.cumsum(slot_flat, axis=1) - slot_flat).reshape(B, S, K, E)
    within = (pos < C) & (onehot > 0)
    return np.asarray(within.any(axis=-1))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
def test_moe_apply_matches_jax(arch, capacity_factor):
    """Forward, the aux loss and the gradients of the weights and the input,
    fp32 at 2e-5; the same routes kept and dropped."""
    jcfg, cfg = _moe_cfgs(arch, capacity_factor)
    params = JMOE.moe_init(KEY, jcfg)
    x = jax.random.normal(jax.random.fold_in(KEY, 4), (2, 32, jcfg.d_model), jnp.float32)
    r = jax.random.normal(jax.random.fold_in(KEY, 5), x.shape, jnp.float32)

    def j_obj(p, x_):
        y, aux = JMOE.moe_apply(p, x_, jcfg)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (j_y, j_aux)), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
        j_obj, argnums=(0, 1), has_aux=True))(params, x)
    tp = _t(jax.tree.map(np.asarray, params))
    leaves = {k: v for k, v in tp.items() if not isinstance(v, dict)}
    shared = tp.get("shared", {})
    for t in (*leaves.values(), *shared.values()):
        t.requires_grad_(True)
    tx = torch.from_numpy(np.array(x)).requires_grad_(True)
    y, aux = MOE.moe_apply({**leaves, **({"shared": shared} if shared else {})}, tx, cfg)
    obj = (y * torch.from_numpy(np.array(r))).sum() + aux
    names = [*leaves, *(f"shared.{k}" for k in shared)]
    grads = torch.autograd.grad(obj, [*leaves.values(), *shared.values(), tx])

    y_scale = float(np.abs(np.asarray(j_y)).max())
    assert float((y.detach() - torch.from_numpy(np.array(j_y))).abs().max()) <= F32_REL * y_scale
    assert float(aux.detach()) == pytest.approx(float(j_aux), rel=F32_REL)
    j_flat = {**{k: v for k, v in j_gp.items() if k != "shared"},
              **{f"shared.{k}": v for k, v in j_gp.get("shared", {}).items()}}
    for name, g in zip([*names, "x"], grads):
        expect = np.asarray(j_gx if name == "x" else j_flat[name])
        scale = np.abs(expect).max()
        assert float(np.abs(g.numpy() - expect).max()) <= F32_REL * scale, name

    # the routes: the same kept and dropped (token, slot)s
    _, _, gate_idx = MOE.route(leaves["router"], tx.detach(), cfg)
    kept = (MOE.assign(gate_idx, cfg.moe.n_experts,
                       MOE._capacity(cfg.moe, x.shape[1])) < MOE._capacity(cfg.moe, x.shape[1]))
    j_kept = _reference_kept(params, x, jcfg)
    np.testing.assert_array_equal(kept.numpy(), j_kept)
    if capacity_factor == 8.0:
        assert j_kept.all()
    else:
        assert 0 < j_kept.sum() < j_kept.size / 2        # most routes drop


def test_moe_assign_ranks_by_token_then_slot():
    """The rank is the count of the group's earlier routes to the same
    expert, token-major and slot-minor (a loop over the routes)."""
    rng = np.random.default_rng(0)
    idx = np.stack([np.stack([rng.permutation(6)[:3] for _ in range(20)]) for _ in range(3)])
    ranks = MOE.assign(torch.from_numpy(idx), 6, 10).numpy()
    for g in range(3):
        seen = {}
        for s in range(20):
            for k in range(3):
                e = idx[g, s, k]
                assert ranks[g, s, k] == seen.get(e, 0)
                seen[e] = seen.get(e, 0) + 1


# --- the reference's MoE property tests (tests/test_model_properties.py) ----

def _port_moe(capacity_factor=8.0):
    jcfg, cfg = _moe_cfgs("mixtral-8x7b", capacity_factor)
    return cfg, _t(jax.tree.map(np.asarray, JMOE.moe_init(KEY, jcfg)))


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("group_size", [1, 8, 64, 1024])
def test_moe_capacity_helper_bounds(group_size):
    jcfg, cfg = _moe_cfgs("mixtral-8x7b", 8.0)
    c = MOE._capacity(cfg.moe, group_size)
    assert c == JMOE._capacity(jcfg.moe, group_size)
    assert cfg.moe.top_k <= c <= max(group_size, cfg.moe.top_k)


def test_moe_outputs_are_convex_combinations_when_no_drops():
    """Capacity factor 8: every token is routed, none maps to exactly zero."""
    cfg, params = _port_moe(8.0)
    x = _x((2, 16, cfg.d_model), 3)
    y, aux = MOE.moe_apply(params, x, cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux) >= 0.0
    assert float(y.reshape(-1, cfg.d_model).norm(dim=-1).min()) > 0.0


def test_moe_dropping_reduces_output_energy():
    """Capacity factor 0.25 against 8: tokens dropped -> less routed mass."""
    big, params = _port_moe(8.0)
    small = _cf(big, 0.25)
    x = _x((2, 32, 64), 4)
    y_big, _ = MOE.moe_apply(params, x, big)
    y_small, _ = MOE.moe_apply(params, x, small)
    assert float(y_small.norm()) < float(y_big.norm())


def test_moe_aux_loss_balanced_router_is_minimal():
    """A uniform router gives aux ~ weight (the analytic minimum of E f.p);
    capacity factor 8."""
    cfg, params = _port_moe(8.0)
    params = {**params, "router": torch.zeros_like(params["router"])}
    _, aux = MOE.moe_apply(params, _x((4, 32, cfg.d_model), 0), cfg)
    assert float(aux) == pytest.approx(cfg.moe.router_aux_weight, rel=0.1)


# --- MLA ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_layer():
    jcfg = jax_get_config("deepseek-v2-lite-16b", reduced=True)
    cfg = get_config("deepseek-v2-lite-16b", reduced=True)
    params = JMLA.mla_init(KEY, jcfg)
    return jcfg, cfg, params, _t(jax.tree.map(np.asarray, params))


def test_mla_prefill_matches_jax(mla_layer):
    """The decompressed path (flash attention at qk 24 / v 16) and its
    latent cache material, fp32 at 2e-5."""
    jcfg, cfg, params, tp = mla_layer
    x = jax.random.normal(jax.random.fold_in(KEY, 7), (2, 12, jcfg.d_model), jnp.float32)
    positions = jnp.arange(12)[None, :]
    j_out, j_cache = jax.jit(lambda p, x_: JMLA.mla_apply(p, x_, jcfg, positions=positions))(
        params, x)
    out, cache = MLA.mla_apply(tp, torch.from_numpy(np.array(x)), cfg,
                               positions=torch.arange(12)[None, :])
    for got, expect in ((out, j_out), (cache["c_kv"], j_cache["c_kv"]),
                        (cache["k_rope"], j_cache["k_rope"])):
        expect = np.asarray(expect)
        assert got.shape == expect.shape
        assert float(np.abs(got.numpy() - expect).max()) <= F32_REL * np.abs(expect).max()


@pytest.mark.parametrize("s_new", [1, 3])
def test_mla_absorbed_decode_matches_jax(mla_layer, s_new):
    """The absorbed decode against the compressed cache, from a cache of 9
    valid entries in 16 slots, fp32 at 2e-5; the cache written in place."""
    jcfg, cfg, params, tp = mla_layer
    m, pos, S_max = cfg.mla, 9, 16
    rng = np.random.default_rng(11)
    ckv = rng.standard_normal((2, S_max, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((2, S_max, m.qk_rope_head_dim)).astype(np.float32)
    ckv[:, pos:] = krope[:, pos:] = 0.0
    x = rng.standard_normal((2, s_new, cfg.d_model)).astype(np.float32)
    positions = pos + np.arange(s_new)[None, :]
    j_out, j_cache = jax.jit(lambda p, x_, c: JMLA.mla_apply(
        p, x_, jcfg, positions=jnp.asarray(positions), cache=c))(
        params, jnp.asarray(x), {"c_kv": jnp.asarray(ckv), "k_rope": jnp.asarray(krope),
                                 "pos": jnp.asarray(pos, jnp.int32)})
    cache = {"c_kv": torch.from_numpy(ckv.copy()), "k_rope": torch.from_numpy(krope.copy()),
             "pos": pos}
    out, new = MLA.mla_apply(tp, torch.from_numpy(x), cfg,
                             positions=torch.from_numpy(positions), cache=cache)
    assert new["pos"] == int(j_cache["pos"]) == pos + s_new
    assert new["c_kv"] is cache["c_kv"]
    for got, expect in ((out, j_out), (new["c_kv"], j_cache["c_kv"]),
                        (new["k_rope"], j_cache["k_rope"])):
        expect = np.asarray(expect)
        assert float(np.abs(got.numpy() - expect).max()) <= F32_REL * np.abs(expect).max()


def test_mla_absorbed_decode_matches_decompressed():
    """The reference's property test on the port (capacity factor 8): the
    latent-space decode of the last token equals decompress-then-attend, on
    the whole reduced deepseek model."""
    jcfg, cfg = _moe_cfgs("deepseek-v2-lite-16b", 8.0)
    jparams = jax.jit(jax_build_model(jcfg).init)(KEY)
    bundle = build_model(cfg)
    model = bundle.init(device="meta").to_empty(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    S = 10
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))
    with torch.inference_mode():
        full, _ = bundle.forward(model, {"tokens": tokens})
        _, cache = bundle.prefill(model, {"tokens": tokens[:, :S - 1]}, pad_to=S)
        logits, _ = bundle.decode(model, cache, {"tokens": tokens[:, S - 1:S]})
    scale = float(full.abs().max()) + 1e-6
    assert float((logits[:, 0] - full[:, S - 1]).abs().max()) / scale < 1e-5
