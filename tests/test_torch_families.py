"""Port parity for the MoE, MLA, vision-stub and encoder-decoder families:
mixtral-8x7b (MoE, GQA, sliding window), deepseek-v2-lite-16b (MoE with
shared experts and a leading dense layer, MLA), phi-3-vision-4.2b (projected
patch embeddings) and whisper-tiny (encoder-decoder, LayerNorm, GELU), each
reduced, against the JAX package. The weights come from the JAX init through
`params_from_jax`, and both sides get the same numpy batches, stub inputs
included. Forward, loss (with the MoE aux loss), every gradient, prefill +
decode and a 3-step AsyncSAM AdamW trajectory; then the launchers on the CPU.

Capacity factors: the forward, loss, gradient and trajectory tests run the
configs' own (1.25), where the MoE layers drop routes; the prefill + decode
test runs 8, where none drops (the capacity depends on the group's length,
so a prompt and its decode steps drop differently at 1.25), as the
reference's serving test does.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.registry import whisper_enc_len as jax_whisper_enc_len
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference, params_from_jax, to_reference
from repro_torch.models.registry import whisper_enc_len
from test_torch_dense_configs import (COS_ATOL, GRAD_TOL, TRAJ_BULK, TRAJ_MAX, TRAJ_RTOL,
                                      _port_fit)
from test_torch_train import _jax_fit

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("mixtral-8x7b", "deepseek-v2-lite-16b", "phi-3-vision-4.2b", "whisper-tiny")
F32_REL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _load(cfg, tree):
    model = build_model(cfg).init(device="meta").to_empty(device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    """(jax config, port config, JAX init, numpy tree of it, port model)."""
    arch = request.param
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree, _load(cfg, tree)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _batch(cfg, b=2, s=24, seed=1) -> dict:
    """Tokens, labels and the config's stub inputs, numpy (fp32 stubs)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.vision is not None:
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.vision.n_image_tokens, cfg.vision.clip_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["enc_frames"] = rng.standard_normal(
            (b, whisper_enc_len(cfg, s), cfg.d_model)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_state_dict_names_are_the_reference_leaves(reduced):
    """`params_from_jax` maps every leaf of the reference's tree onto a port
    parameter of the same shape, the port has no other, and `to_reference`
    rebuilds the reference's tree structure (deepseek's `dense_blocks` a
    list, the blocks stacked)."""
    jcfg, cfg, jparams, tree, model = reduced
    named = from_reference(tree)
    sd = model.state_dict()
    assert set(named) == set(sd)
    for name, leaf in named.items():
        assert tuple(sd[name].shape) == tuple(leaf.shape), name
    back = to_reference(sd, leaf=lambda t: t.numpy())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    if cfg.moe is not None:
        assert {"blocks.0.moe.router", "blocks.0.moe.we_in", "blocks.0.moe.we_gate",
                "blocks.0.moe.we_out"} <= set(sd)
        assert ("blocks.0.moe.shared.wi" in sd) == bool(cfg.moe.n_shared_experts)
        assert sum(n.startswith("dense_blocks.") and n.endswith(".mlp.wi") for n in sd) \
            == cfg.moe.first_dense_layers
    if cfg.mla is not None:
        assert {n.split(".")[-1] for n in sd if n.startswith("blocks.0.attn.")} == {
            "wq", "w_dkv", "kv_norm_scale", "w_uk", "w_uv", "wo"}
    assert ("projector" in sd) == (cfg.vision is not None)
    if cfg.family == "audio":
        assert {"frontend_adapter", "enc_norm.scale", "enc_norm.bias",
                "dec_blocks.0.cross_attn.wk", "dec_blocks.1.ln3.bias",
                "enc_blocks.1.attn.wo"} <= set(sd)


def test_forward_loss_and_gradients_match_jax(reduced):
    """fp32 at the configs' capacity factor (1.25): the logits to 2e-5 of
    their max, the loss and the MoE aux loss to 2e-5 relative, each gradient
    leaf to 2e-5 of the model's largest gradient element."""
    jcfg, cfg, jparams, _, model = reduced
    batch = _batch(cfg)
    jb = jax_build_model(jcfg)
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(jb.loss_fn, has_aux=True))(
        jparams, _jnp(batch), None)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in model.state_dict().items()}
    loss, aux = build_model(cfg).loss_fn(params, _torch(batch))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    scale = float(np.abs(_np(j_aux["logits"])).max())
    assert np.abs(_np(aux["logits"]) - _np(j_aux["logits"])).max() <= F32_REL * scale
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=F32_REL)
    moe_aux = float(aux["moe_aux"].detach())
    assert moe_aux == pytest.approx(float(j_aux["moe_aux"]), rel=F32_REL, abs=1e-12)
    assert (moe_aux > 0) == (cfg.moe is not None)
    j_sd = params_from_jax(jax.tree.map(np.asarray, j_grads))
    assert set(j_sd) == set(grads)
    gscale = max(float(g.abs().max()) for g in j_sd.values())
    for name, g in grads.items():
        err = float((g - j_sd[name]).abs().max())
        assert err <= GRAD_TOL * gscale, (name, err / gscale)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "whisper-tiny"])
def test_remat_keeps_loss_aux_and_gradients(arch, remat):
    """The full configs checkpoint every block (remat "full"): the MoE and
    MLA blocks, deepseek's dense one and whisper's encoder and decoder
    blocks recompute in backward, and the loss, the aux loss summed over the
    layers and every gradient stay those of remat "none" (capacity factor
    1.25)."""
    cfg = get_config(arch, reduced=True)
    tree = jax.tree.map(np.asarray, jax.jit(jax_build_model(
        jax_get_config(arch, reduced=True)).init)(jax.random.PRNGKey(0)))
    sd = _load(cfg, tree).state_dict()
    batch = _torch(_batch(cfg))
    out = {}
    for r in ("none", remat):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in sd.items()}
        loss, aux = build_model(dataclasses.replace(cfg, remat=r)).loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        out[r] = (float(loss.detach()), float(aux["moe_aux"].detach()), grads)
    assert out[remat][0] == pytest.approx(out["none"][0], rel=1e-6)
    assert out[remat][1] == pytest.approx(out["none"][1], rel=1e-6, abs=1e-12)
    for g, g0 in zip(out[remat][2], out["none"][2]):
        torch.testing.assert_close(g, g0, rtol=1e-5, atol=1e-6)


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def test_prefill_decode_match_forward(reduced):
    """Capacity factor 8 (no drops): prefill's last logits and 4 decode
    steps' against one forward of the port over the same tokens, to 1e-4 of
    the logits' max (the reference's serving test holds its own to that),
    and prefill's logits against the reference's prefill to 2e-5; the cache's
    structure and pos as the reference's."""
    jcfg, cfg, jparams, _, model = reduced
    jcfg, cfg = _no_drop(jcfg), _no_drop(cfg)
    S, n_dec = 12, 4
    batch = _batch(cfg, b=2, s=S + n_dec, seed=3)
    bundle, jb = build_model(cfg), jax_build_model(jcfg)
    pre = {k: (v[:, :S] if k in ("tokens", "labels") else v) for k, v in batch.items()}
    with torch.inference_mode():
        full, _ = bundle.forward(model, _torch(batch))
        logits, cache = bundle.prefill(model, _torch(pre), pad_to=S + n_dec)
        j_logits, j_cache = jax.jit(lambda p, b: jb.prefill(p, b, pad_to=S + n_dec))(
            jparams, _jnp(pre))
        scale = float(full.abs().max())
        assert np.abs(_np(logits) - _np(j_logits)).max() <= F32_REL * scale
        assert cache["pos"] == int(j_cache["pos"]) == S
        j_shapes = jax.tree.map(lambda a: tuple(a.shape),
                                {k: v for k, v in j_cache.items() if k != "pos"})
        shapes = jax.tree.map(lambda a: tuple(a.shape),
                              {k: v for k, v in cache.items() if k != "pos"})
        assert shapes == j_shapes
        errs = [float((logits[:, -1] - full[:, S - 1]).abs().max())]
        for t in range(S, S + n_dec):
            logits, cache = bundle.decode(model, cache,
                                          {"tokens": torch.from_numpy(batch["tokens"][:, t:t + 1])})
            errs.append(float((logits[:, -1] - full[:, t]).abs().max()))
        assert cache["pos"] == S + n_dec
    assert max(errs) <= 1e-4 * scale, (errs, scale)


def test_init_cache_matches_the_reference(reduced):
    jcfg, cfg, _, _, _ = reduced
    jc = jax_build_model(jcfg).init_cache(2, 10, pos=3)
    c = build_model(cfg).init_cache(2, 10, pos=3, device="cpu")
    assert c["pos"] == int(jc["pos"]) == 3
    shapes = jax.tree.map(lambda a: tuple(a.shape), {k: v for k, v in c.items() if k != "pos"})
    j_shapes = jax.tree.map(lambda a: tuple(a.shape),
                            {k: v for k, v in jc.items() if k != "pos"})
    assert shapes == j_shapes
    assert not any(bool(t.any()) for t in jax.tree.leaves(
        {k: v for k, v in c.items() if k != "pos"}))


TRAJ_STEPS = 3


def test_async_sam_trajectory_matches_jax(reduced):
    """Three AsyncSAM AdamW steps at lr 3e-3 from the same weights on the
    same batches (stub inputs included; capacity factor 1.25), held as
    `test_torch_dense_configs.py` holds its trajectories."""
    jcfg, cfg, jparams, tree, _ = reduced
    rep = _port_fit(cfg, _load(cfg, tree), TRAJ_STEPS)
    jrep = _jax_fit(jcfg, jparams, {}, steps=TRAJ_STEPS)
    assert rep.steps_done == jrep.steps_done == TRAJ_STEPS
    for i, (m, jm) in enumerate(zip(rep.metrics_history, jrep.metrics_history)):
        assert m["perturbed"] == jm["perturbed"] == (0.0 if i == 0 else 1.0)
        for k in ("loss", "ascent_loss", "ascent_norm", "grad_norm", "moe_aux"):
            assert m[k] == pytest.approx(jm[k], rel=TRAJ_RTOL, abs=1e-12), (i, k, m[k], jm[k])
        assert m["ascent_cosine"] == pytest.approx(jm["ascent_cosine"], abs=COS_ATOL), i
    st, jst = rep.final_state, jrep.final_state
    for name, (b, jb) in {"w": (st.params, jst.params),
                          "mu": (st.opt_state[0].mu, jst.opt_state[0].mu),
                          "nu": (st.opt_state[0].nu, jst.opt_state[0].nu),
                          "ascent_grad": (st.method_state.ascent_grad,
                                          jst.method_state.ascent_grad)}.items():
        got, expect = b.buffers[0].numpy(), np.asarray(jb.buffers[0])
        assert got.shape == expect.shape, name
        diff, scale = np.abs(got - expect), np.abs(expect).max()
        assert np.quantile(diff, 0.999) <= TRAJ_BULK * scale, name
        assert diff.max() <= TRAJ_MAX * scale, (name, diff.max() / scale)


@pytest.mark.parametrize("dec_len", [1, 12, 1500, 4096])
def test_whisper_enc_len_matches_the_reference(dec_len):
    cfg, jcfg = get_config("whisper-tiny"), jax_get_config("whisper-tiny")
    assert whisper_enc_len(cfg, dec_len) == jax_whisper_enc_len(jcfg, dec_len)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_train_cli_deepseek_runs_to_done(tmp_path):
    out = _run("repro_torch.launch.train", "--arch", "deepseek-v2-lite-16b", "--reduced",
               "--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
               "--log-every", "4", "--save-every", "6", "--ckpt-dir", str(tmp_path / "ck"))
    aux = [float(x) for x in re.findall(r"'moe_aux': '([0-9.]+)'", out)]
    assert len(aux) == 3 and all(a > 0 for a in aux), out
    assert re.search(r"^done: 12 steps, 0 restarts", out, re.M), out
    assert '"flash_attention": 0' in out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_answers(arch):
    out = _run("repro_torch.launch.serve", "--arch", arch, "--reduced", "--device", "cpu",
               "--requests", "2", "--prompt-len", "12", "--max-new", "4")
    assert "flash_attention kernel launches: 0" in out
    tokens = re.search(r"sample continuation \(request 0\): \[([0-9, ]+)\]", out)
    assert tokens and len(tokens.group(1).split(",")) == 4, out
