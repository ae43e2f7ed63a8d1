"""Port parity for the dense configs gemma-2b (MQA, head_dim 256, tanh-GELU,
tied embeddings), qwen3-8b (GQA, parameter-free qk_norm, rope 1e6) and
qwen2.5-32b (GQA, q/k/v biases), each reduced, against the JAX package:
the weights come from the JAX init through `params_from_jax`, and both sides
get the same numpy batches. Forward, prefill + decode, the loss, every
gradient and a K-step AsyncSAM AdamW trajectory; then the launchers on the
CPU.
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
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import Engine, FusedExecutor
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import from_reference, params_from_jax
from test_torch_model import _slice_parity
from test_torch_train import _jax_fit

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("gemma-2b", "qwen3-8b", "qwen2.5-32b")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    """(jax config, port config, JAX init, numpy tree of it, port model)."""
    arch = request.param
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jcfg, cfg, jparams, tree, model


def test_state_dict_names_are_the_reference_leaves(reduced):
    """`params_from_jax` maps every leaf of the reference's tree onto a port
    parameter of the same shape, and the port has no other: the q/k/v biases
    of qkv_bias; qk_norm has no parameters in either package."""
    jcfg, cfg, _, tree, model = reduced
    named = from_reference(tree)
    sd = model.state_dict()
    assert set(named) == set(sd)
    for name, leaf in named.items():
        assert tuple(sd[name].shape) == tuple(leaf.shape), name
    attn = {n.split(".")[-1] for n in sd if n.startswith("blocks.0.attn.")}
    assert attn == ({"wq", "wk", "wv", "wo"} | ({"bq", "bk", "bv"} if cfg.qkv_bias else set()))
    assert ("embedding.unembed" in sd) == (not cfg.tie_embeddings)
    assert model.blocks[0].attn.wk.shape[-1] == cfg.n_kv_heads * cfg.resolved_head_dim


def test_forward_prefill_decode_match_jax(reduced):
    """Forward, prefill and 4 greedy decode steps in fp32, to 2e-5 of the
    logits' max (the reference's fp32 kernel tolerance), the same tokens."""
    jcfg, cfg, jparams, _, model = reduced
    _slice_parity(jcfg, cfg, jparams, model, rel_tol=2e-5, check_tokens=True)


def _batch(cfg, b=2, s=24, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


# The loss to 2e-5 relative; each gradient leaf to 2e-5 of the largest
# gradient element of the model (a leaf whose gradient is small is held at
# the scale of the sums' rounding, not at its own).
GRAD_TOL = 2e-5


def test_loss_and_gradients_match_jax(reduced):
    jcfg, cfg, jparams, _, model = reduced
    batch = _batch(cfg)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss_fn,
                                                      has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in model.state_dict().items()}
    loss, _ = build_model(cfg).loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=2e-5)
    j_sd = params_from_jax(jax.tree.map(np.asarray, j_grads))
    assert set(j_sd) == set(grads)
    scale = max(float(g.abs().max()) for g in j_sd.values())
    for name, g in grads.items():
        err = float((g - j_sd[name]).abs().max())
        assert err <= GRAD_TOL * scale, (name, err / scale)


TRAJ_STEPS, BATCH, SEQ = 4, 8, 32


def _port_fit(cfg, model, steps):
    ex = FusedExecutor(build_model(cfg).loss_fn,
                       MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.25),
                       optim.make_optimizer("adamw", optim.cosine_schedule(3e-3, steps)))
    state = ex.init_state(model, seed=1)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=BATCH, seq_len=SEQ, seed=0,
                                             ascent_fraction=0.25, prefetch=0), device="cpu")
    with Engine(ex, pipe) as eng:
        return eng.fit(state, steps)


# Four AsyncSAM AdamW steps at lr 3e-3 from the same weights on the same
# batches: every step's scalar metrics to 2e-5 relative (the reference's
# fp32 tolerance). The state as tests/test_torch_train.py holds it: the sides
# differ in the order of sums (~1e-7), and a weight whose gradient sits at
# that noise may take Adam's ~lr step the other way, so 99.9% of each
# buffer's elements are held to 1e-4 of its max and every element to 1e-3.
TRAJ_RTOL, TRAJ_BULK, TRAJ_MAX, COS_ATOL = 2e-5, 1e-4, 1e-3, 5e-3


def test_async_sam_trajectory_matches_jax(reduced):
    jcfg, cfg, jparams, tree, _ = reduced
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(params_from_jax(tree))
    rep = _port_fit(cfg, model, TRAJ_STEPS)
    jrep = _jax_fit(jcfg, jparams, {}, steps=TRAJ_STEPS)
    assert rep.steps_done == jrep.steps_done == TRAJ_STEPS
    for i, (m, jm) in enumerate(zip(rep.metrics_history, jrep.metrics_history)):
        assert m["perturbed"] == jm["perturbed"] == (0.0 if i == 0 else 1.0)
        for k in ("loss", "ascent_loss", "ascent_norm", "grad_norm"):
            assert m[k] == pytest.approx(jm[k], rel=TRAJ_RTOL), (i, k, m[k], jm[k])
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


def test_bf16_compute_matches_jax():
    """gemma-2b's head_dim 256 and MQA in bf16 compute on both sides (fp32
    weights), to the reference's bf16 tolerance of the logits' max."""
    jcfg, cfg = jax_get_config("gemma-2b", reduced=True), get_config("gemma-2b", reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    _slice_parity(dataclasses.replace(jcfg, compute_dtype="bfloat16"),
                  dataclasses.replace(cfg, compute_dtype="bfloat16"), jparams, model,
                  rel_tol=2e-2, check_tokens=False)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def _run(*args, timeout=240):
    # two threads, as the in-process tests: the suite runs timing-sensitive
    # tests in the workers beside this one
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_train_cli_gemma_looksam_runs_to_done(tmp_path):
    out = _run("repro_torch.launch.train", "--arch", "gemma-2b", "--reduced", "--device",
               "cpu", "--method", "looksam", "--steps", "6", "--batch", "4", "--seq", "32",
               "--log-every", "1", "--save-every", "3", "--ckpt-dir", str(tmp_path / "ck"))
    fresh = [float(x) for x in re.findall(r"'fresh': '([0-9.]+)'", out)]
    assert fresh == [1.0, 0.0] * 3, out
    assert re.search(r"^done: 6 steps, 0 restarts", out, re.M), out
    assert '"method": "looksam"' in out.splitlines()[-1]


def test_serve_cli_qwen3_answers():
    out = _run("repro_torch.launch.serve", "--arch", "qwen3-8b", "--reduced", "--device", "cpu",
               "--requests", "2", "--prompt-len", "12", "--max-new", "4")
    assert "flash_attention kernel launches: 0" in out
    tokens = re.search(r"sample continuation \(request 0\): \[([0-9, ]+)\]", out)
    assert tokens and len(tokens.group(1).split(",")) == 4, out
