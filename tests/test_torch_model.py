"""Port parity for the dense model slice (olmo-1b): layers, forward, prefill +
decode, weight conversion and the synthetic token stream, each against the JAX
package on the same inputs and the same (converted) weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.data.synthetic import TokenTask as JaxTokenTask
from repro.models import build_model as jax_build_model
from repro.models import cross_entropy as jax_cross_entropy
from repro.models import layers as JL
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import TokenTask
from repro_torch.models import (analytic_param_count, build_model, cross_entropy,
                                layers as L, synth_batch, transformer)
from repro_torch.models.convert import params_from_jax

F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def reduced():
    """olmo-1b-reduced: the JAX init, and the port's model loaded from it."""
    jcfg, cfg = jax_get_config("olmo-1b", reduced=True), get_config("olmo-1b", reduced=True)
    # the JAX side runs jitted throughout: one compile instead of one per primitive
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jcfg, cfg, jparams, model


def test_configs_are_copies_of_the_reference():
    """All ten of the reference's archs, in its order, field for field."""
    assert ARCH_IDS == JAX_ARCH_IDS == (
        "mixtral-8x7b", "deepseek-v2-lite-16b", "zamba2-1.2b", "gemma-2b", "qwen2.5-32b",
        "qwen3-8b", "olmo-1b", "phi-3-vision-4.2b", "rwkv6-7b", "whisper-tiny")
    for arch in ARCH_IDS:
        for reduced_ in (False, True):
            assert (dataclasses.asdict(get_config(arch, reduced=reduced_))
                    == dataclasses.asdict(jax_get_config(arch, reduced=reduced_))), arch
    with pytest.raises(ValueError):
        get_config("mixtral-8x22b")


@pytest.mark.parametrize("reduced_", [True, False])
def test_param_count_matches_reference(reduced_):
    jcfg = jax_get_config("olmo-1b", reduced=reduced_)
    cfg = get_config("olmo-1b", reduced=reduced_)
    assert analytic_param_count(cfg) == cfg.param_count() == jcfg.param_count()


# the reference's analytic counts at full size (all, active): the expert
# weights of the top-k experts only count as active
FULL_COUNTS = {"mixtral-8x7b": (46_702_792_704, 12_879_925_248),
               "deepseek-v2-lite-16b": (15_706_484_224, 2_661_150_208),
               "phi-3-vision-4.2b": (3_824_225_280, 3_824_225_280),
               "whisper-tiny": (36_595_584, 36_595_584)}


@pytest.mark.parametrize("arch", list(FULL_COUNTS))
def test_full_param_counts_match_reference(arch):
    """Built on the meta device (no memory); `active_only` too."""
    from repro.models import analytic_param_count as jax_analytic_param_count
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    total, active = FULL_COUNTS[arch]
    assert analytic_param_count(cfg) == jax_analytic_param_count(jcfg) == total
    assert (analytic_param_count(cfg, active_only=True)
            == jax_analytic_param_count(jcfg, active_only=True) == active)


def test_state_dict_names_mirror_jax_leaves(reduced):
    _, cfg, _, model = reduced
    names = set(model.state_dict())
    assert {"embedding.embed", "blocks.0.attn.wq", "blocks.1.attn.wo",
            "blocks.0.mlp.wi", "blocks.0.mlp.wg", "blocks.1.mlp.wo_mlp"} <= names
    assert len(names) == 1 + cfg.n_layers * 7


def test_bf16_leaves_cross_as_bits():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 2, 4)), jnp.bfloat16)
    tree = {"embedding": {"embed": np.asarray(x[0])},
            "blocks": {"attn": {"wq": np.asarray(x).view(np.uint16)}}}
    sd = params_from_jax(tree)
    assert sd["embedding.embed"].dtype == torch.bfloat16
    assert sorted(sd) == ["blocks.0.attn.wq", "blocks.1.attn.wq", "blocks.2.attn.wq",
                          "embedding.embed"]
    for i in range(3):
        got = sd[f"blocks.{i}.attn.wq"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(x[i]).view(np.uint16))


def test_init_draws_the_reference_distributions():
    cfg = get_config("olmo-1b", reduced=True)
    model = transformer.init_params(cfg, seed=0, device="cpu")
    again = transformer.init_params(cfg, seed=0, device="cpu")
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    embed = model.embedding.embed
    assert abs(float(embed.std()) - 0.02) < 0.002
    wq = model.blocks[0].attn.wq
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6


# ---------------------------------------------------------------------------
# layers, on the converted block-0 weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["nonparam_ln", "rmsnorm", "layernorm"])
def test_norm_apply(norm):
    jcfg = dataclasses.replace(jax_get_config("olmo-1b", reduced=True), norm=norm)
    cfg = dataclasses.replace(get_config("olmo-1b", reduced=True), norm=norm)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {name: rng.standard_normal(64).astype(np.float32)
         for name in L.norm_shapes(cfg, 64)}
    expect = jax.jit(JL.norm_apply, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    got = L.norm_apply({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    np.testing.assert_allclose(_np(got), _np(expect), **F32_TOL)


@pytest.mark.parametrize("offset", [0, 9])
def test_apply_rope(offset):
    x = np.random.default_rng(1).standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = (np.arange(7) + offset)[None, :]
    expect = jax.jit(JL.apply_rope, static_argnums=2)(jnp.asarray(x), jnp.asarray(pos),
                                                      10000.0)
    got = L.apply_rope(_t(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(_np(got), _np(expect), **F32_TOL)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_mlp_apply(reduced, act, gated):
    jcfg, cfg, jparams, model = reduced
    jcfg = dataclasses.replace(jcfg, act=act, mlp_gated=gated)
    cfg = dataclasses.replace(cfg, act=act, mlp_gated=gated)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["mlp"])
    expect = jax.jit(JL.mlp_apply, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    got = L.mlp_apply(L.params_of(model.blocks[0].mlp), _t(x), cfg)
    np.testing.assert_allclose(_np(got), _np(expect), **F32_TOL)


def test_attention_apply_prefill_branch(reduced):
    jcfg, cfg, jparams, model = reduced
    x = np.random.default_rng(3).standard_normal((2, 9, 64)).astype(np.float32)
    pos = np.arange(9)[None, :]
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["attn"])
    j_out, j_kv = jax.jit(lambda p_, x_, pos_: JL.attention_apply(p_, x_, jcfg, positions=pos_))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    out, kv = L.attention_apply(L.params_of(model.blocks[1].attn), _t(x), cfg,
                                positions=torch.from_numpy(pos))
    np.testing.assert_allclose(_np(out), _np(j_out), **F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(kv[name]), _np(j_kv[name]), **F32_TOL)


def test_attention_apply_decode_branch(reduced):
    jcfg, cfg, jparams, model = reduced
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    k0 = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    v0 = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos = 7
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    j_out, j_cache = jax.jit(
        lambda p_, x_, pos_, c_: JL.attention_apply(p_, x_, jcfg, positions=pos_, cache=c_))(
        jp, jnp.asarray(x), jnp.asarray([[pos]]),
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0), "pos": jnp.asarray(pos)})
    cache = {"k": _t(k0), "v": _t(v0), "pos": pos}
    out, new = L.attention_apply(L.params_of(model.blocks[0].attn), _t(x), cfg,
                                 positions=torch.tensor([[pos]]), cache=cache)
    np.testing.assert_allclose(_np(out), _np(j_out), **F32_TOL)
    assert new["pos"] == int(j_cache["pos"]) == pos + 1
    for name in ("k", "v"):
        assert new[name] is cache[name]          # written in place
        np.testing.assert_allclose(_np(new[name]), _np(j_cache[name]), **F32_TOL)


# ---------------------------------------------------------------------------
# the whole slice: JAX init -> params_from_jax -> port
# ---------------------------------------------------------------------------

def _slice_parity(jcfg, cfg, jparams, model, rel_tol, check_tokens):
    jb = jax_build_model(jcfg)
    S, n_dec = 12, 4
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, S + n_dec),
                                               dtype=np.int32)
    j_full, _ = jax.jit(jb.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        full, aux = transformer.forward(model, {"tokens": torch.from_numpy(tokens)}, cfg)
    scale = float(np.abs(_np(j_full)).max())
    assert float(aux) == 0.0 and full.dtype == L.cdtype(cfg)
    assert np.abs(_np(full) - _np(j_full)).max() <= rel_tol * scale

    prompt = tokens[:, :S]
    j_logits, j_cache = jax.jit(lambda p, b: jb.prefill(p, b, pad_to=S + n_dec))(
        jparams, {"tokens": jnp.asarray(prompt)})
    with torch.inference_mode():
        logits, cache = transformer.prefill(model, {"tokens": torch.from_numpy(prompt)},
                                            cfg, pad_to=S + n_dec)
    assert cache["pos"] == int(j_cache["pos"]) == S
    assert tuple(cache["layers"]["k"].shape) == tuple(j_cache["layers"]["k"].shape)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache["layers"][name]),
                                   _np(j_cache["layers"][name]),
                                   rtol=rel_tol * 10, atol=rel_tol * 10)
    j_decode = jax.jit(jb.decode)
    for step in range(n_dec):
        assert np.abs(_np(logits) - _np(j_logits)).max() <= rel_tol * scale, step
        j_tok = np.asarray(jnp.argmax(j_logits[:, -1], axis=-1))[:, None].astype(np.int32)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        if check_tokens:
            np.testing.assert_array_equal(tok.numpy(), j_tok)
        j_logits, j_cache = j_decode(jparams, j_cache, {"tokens": jnp.asarray(j_tok)})
        with torch.inference_mode():
            logits, cache = transformer.decode(model, cache,
                                               {"tokens": torch.from_numpy(j_tok)}, cfg)
        assert cache["pos"] == int(j_cache["pos"]) == S + step + 1
    assert np.abs(_np(logits) - _np(j_logits)).max() <= rel_tol * scale


def test_olmo_reduced_forward_prefill_decode_match_jax(reduced):
    _slice_parity(*reduced, rel_tol=1e-4, check_tokens=True)


def test_olmo_reduced_bf16_compute_matches_jax(reduced):
    """Same (fp32) weights, bf16 compute on both sides."""
    jcfg, cfg, jparams, model = reduced
    _slice_parity(dataclasses.replace(jcfg, compute_dtype="bfloat16"),
                  dataclasses.replace(cfg, compute_dtype="bfloat16"), jparams, model,
                  rel_tol=2e-2, check_tokens=False)


def test_init_cache_matches_prefill_structure():
    cfg = get_config("olmo-1b", reduced=True)
    jc = jax_build_model(jax_get_config("olmo-1b", reduced=True)).init_cache(2, 10, pos=3)
    c = transformer.init_cache(cfg, 2, 10, pos=3, device="cpu")
    assert c["pos"] == int(jc["pos"]) == 3
    for name in ("k", "v"):
        assert tuple(c["layers"][name].shape) == tuple(jc["layers"][name].shape)
        assert not c["layers"][name].any()


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,stream", [(256, 0), (256, 3), (50304, 1)])
def test_token_task_is_bit_identical(vocab, stream):
    got = TokenTask(vocab_size=vocab, seed=7).sample(3, 20, stream=stream)
    expect = JaxTokenTask(vocab_size=vocab, seed=7).sample(3, 20, stream=stream)
    assert got.dtype == expect.dtype == np.int32
    np.testing.assert_array_equal(got, expect)
    b, jb = TokenTask(vocab, 7).batch(2, 9, stream), JaxTokenTask(vocab, 7).batch(2, 9, stream)
    np.testing.assert_array_equal(b["labels"], np.asarray(jb["labels"]))


# ---------------------------------------------------------------------------
# registry: loss and batches
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((2, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    labels[:, -1] = -1
    labels[1, 2] = -1
    expect = jax.jit(jax_cross_entropy)(jnp.asarray(logits), jnp.asarray(labels))
    got = cross_entropy(_t(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(expect), rtol=2e-6)
    assert float(cross_entropy(_t(logits), torch.full((2, 7), -1))) == 0.0


def test_loss_fn_matches_jax(reduced):
    jcfg, cfg, jparams, model = reduced
    batch = synth_batch(cfg, 2, 10, seed=3, device="cpu")
    assert batch["tokens"].dtype == torch.int32 and batch["tokens"].shape == (2, 10)
    torch.testing.assert_close(batch["labels"][:, :-1], batch["tokens"][:, 1:])
    assert bool((batch["labels"][:, -1] == -1).all())
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    j_loss, j_aux = jax.jit(jax_build_model(jcfg).loss_fn)(jparams, jbatch,
                                                           jax.random.PRNGKey(0))
    with torch.inference_mode():
        loss, aux = build_model(cfg).loss_fn(model, batch)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=2e-5)
    np.testing.assert_allclose(float(aux["ce"]), float(j_aux["ce"]), rtol=2e-5)
