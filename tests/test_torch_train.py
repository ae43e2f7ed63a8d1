"""Port parity for the Form A AsyncSAM training step: the methods' closed
forms on quadratics, a six-step AsyncSAM trajectory on olmo-1b-reduced against
the JAX package (same init, bit-identical batches), the pipeline, remat and
the flash-attention gradient, and the training launcher on the CPU.

The reference runs meshless, its kernels through their jnp oracles
(`FusedExecutor(mesh=None, fused_update=True, resident=True)` on the CPU, as
tests/test_fused_update.py runs it). The port runs its plain versions: every
tensor here lies on the CPU.
"""
import dataclasses
import json
import math
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

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core import MethodConfig as JMethodConfig
from repro.core import init_train_state as jax_init_train_state
from repro.core import make_method as jax_make_method
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.engine import Engine as JEngine
from repro.engine import FusedExecutor as JFusedExecutor
from repro.models import build_model as jax_build_model
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig, init_train_state, make_method, perturb
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import Engine, FusedExecutor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import buckets

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# closed forms on the quadratic L(w) = 0.5 w'Aw (tests/test_methods.py),
# with AdamW as the inner optimizer (SGD's are in tests/test_torch_sgd.py);
# the AdamW recursion is written out in float64 numpy
# ---------------------------------------------------------------------------

LR, RHO, WD = 0.05, 0.1, 0.01
W0 = np.arange(1.0, 7.0)


def _quad_A(dim=6, seed=0):
    m = np.random.default_rng(seed).standard_normal((dim, dim))
    return m @ m.T / dim + np.eye(dim)


def quad_loss(params, batch, gen):
    w = params["w"]
    return 0.5 * w @ batch["A"] @ w, {}


def jax_quad_loss(params, batch, rng):
    w = params["w"]
    return 0.5 * w @ batch["A"] @ w, {}


class NpAdamW:
    """The reference's adamw chain (scale_by_adam, decay, lr), float64."""

    def __init__(self, lr=LR, wd=WD, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, wd, b1, b2, eps
        self.mu = self.nu = 0.0
        self.t = 0

    def step(self, w, g):
        self.t += 1
        self.mu = self.b1 * self.mu + (1 - self.b1) * g
        self.nu = self.b2 * self.nu + (1 - self.b2) * g * g
        upd = ((self.mu / (1 - self.b1 ** self.t))
               / (np.sqrt(self.nu / (1 - self.b2 ** self.t)) + self.eps))
        return w - self.lr * (upd + self.wd * w)


def _port_run(name, steps, **kw):
    A = _quad_A()
    method = make_method(MethodConfig(name=name, rho=RHO, **kw))
    opt = optim.adamw(LR)
    state = init_train_state({"w": torch.tensor(W0, dtype=torch.float32)}, opt, method)
    step = method.make_step(quad_loss, opt)
    ws, ms = [], []
    for _ in range(steps):
        state, m = step(state, {"A": torch.tensor(A, dtype=torch.float32)})
        ws.append(state.params.to_tree()["w"].clone().numpy())
        ms.append(m)
    return state, ws, ms


def _jax_run(name, steps, **kw):
    A = jnp.asarray(_quad_A(), jnp.float32)
    method = jax_make_method(JMethodConfig(name=name, rho=RHO, **kw))
    opt = joptim.adamw(LR)
    state = jax_init_train_state({"w": jnp.asarray(W0, jnp.float32)}, opt, method,
                                 jax.random.PRNGKey(1))
    step = jax.jit(method.make_step(jax_quad_loss, opt))
    for _ in range(steps):
        state, _ = step(state, {"A": A})
    return np.asarray(state.params["w"])


def test_sgd_method_step_matches_closed_form():
    A = _quad_A()
    _, ws, ms = _port_run("sgd", 2)
    adam, w = NpAdamW(), W0
    for i in range(2):
        g = A @ w
        w = adam.step(w, g)
        np.testing.assert_allclose(ws[i], w, rtol=1e-5)
    np.testing.assert_allclose(ws[-1], _jax_run("sgd", 2), rtol=1e-5)
    assert float(ms[0]["grad_norm"]) == pytest.approx(np.linalg.norm(A @ W0), rel=1e-5)


def test_sam_step_matches_closed_form():
    A = _quad_A()
    _, ws, ms = _port_run("sam", 2)
    adam, w = NpAdamW(), W0
    for i in range(2):
        g = A @ w
        w_hat = w + RHO * g / np.linalg.norm(g)
        w = adam.step(w, A @ w_hat)
        np.testing.assert_allclose(ws[i], w, rtol=1e-5)
    np.testing.assert_allclose(ws[-1], _jax_run("sam", 2), rtol=1e-5)


def test_async_sam_first_step_is_sgd_then_uses_stale_gradient():
    """Algorithm 1: step 0 unperturbed; later steps perturb with a_{t-1}."""
    A = _quad_A()
    _, ws, ms = _port_run("async_sam", 3, ascent_fraction=1.0)
    assert [m["perturbed"] for m in ms] == [0.0, 1.0, 1.0]
    adam, w, a_prev = NpAdamW(), W0, None
    for i in range(3):
        w_hat = w if a_prev is None else w + RHO * a_prev / np.linalg.norm(a_prev)
        a_prev = A @ w                                   # the stored ascent gradient
        w = adam.step(w, A @ w_hat)
        np.testing.assert_allclose(ws[i], w, rtol=1e-5)
        assert float(ms[i]["ascent_norm"]) == pytest.approx(np.linalg.norm(a_prev), rel=1e-5)
    np.testing.assert_allclose(ws[-1], _jax_run("async_sam", 3, ascent_fraction=1.0),
                               rtol=1e-5)


def test_async_sam_interval_staleness_cycles():
    """ascent_interval=2: tau cycles 1, 2, 1, 2; a reused step runs no ascent
    pass and reports the NaN ascent_loss sentinel."""
    taus, reused = [], []
    method = make_method(MethodConfig(name="async_sam", rho=RHO, ascent_fraction=1.0,
                                      ascent_interval=2))
    opt = optim.adamw(LR)
    st = init_train_state({"w": torch.tensor(W0, dtype=torch.float32)}, opt, method)
    step = method.make_step(quad_loss, opt)
    for _ in range(6):
        st, m = step(st, {"A": torch.tensor(_quad_A(), dtype=torch.float32)})
        taus.append(st.method_state.staleness)
        reused.append(m["ascent_reused"])
        assert math.isnan(float(m["ascent_loss"])) == bool(m["ascent_reused"])
    assert taus == [1, 2, 1, 2, 1, 2]
    assert reused == [0.0, 1.0] * 3
    np.testing.assert_allclose(
        st.params.to_tree()["w"].numpy(),
        _jax_run("async_sam", 6, ascent_fraction=1.0, ascent_interval=2), rtol=1e-5)


def test_perturbation_radius():
    rng = np.random.default_rng(0)
    params = {"a": torch.from_numpy(rng.standard_normal(17).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))}
    g = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
         for k, v in params.items()}
    p = buckets.BucketedState.from_tree(params)
    out = p.zeros_like()
    w_hat = perturb(p, buckets.BucketedState.from_tree(g, p.layout), 0.37, out=out)
    assert w_hat.buffers[0] is out.buffers[0]
    delta = w_hat.buffers[0] - p.buffers[0]
    assert float(delta.norm()) == pytest.approx(0.37, rel=1e-5)


def test_microbatch_accumulation_matches_full_batch():
    """n_microbatches=4 reproduces the full-batch step (tests/test_methods.py)."""
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(16).astype(np.float32))

    def loss_fn(params, batch, gen):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}

    outs = []
    for nm in (1, 4):
        method = make_method(MethodConfig(name="async_sam", rho=0.05, n_microbatches=nm,
                                          ascent_fraction=0.25))
        opt = optim.adamw(0.1)
        state = init_train_state({"w": torch.zeros(8)}, opt, method)
        step = method.make_step(loss_fn, opt)
        for _ in range(3):
            state, m = step(state, {"x": X, "y": y})
        outs.append(state.params.buffers[0].clone())
    torch.testing.assert_close(outs[0], outs[1], rtol=2e-5, atol=2e-6)


def test_what_is_not_ported_raises():
    # ported since: the method variants, each with the reference's defaults
    for name in ("gsam", "looksam", "esam", "aesam", "mesa"):
        method = make_method(MethodConfig(name=name))
        assert method.name == name and method.cfg == MethodConfig(name=name)
        assert FusedExecutor(quad_loss, MethodConfig(name=name),
                             optim.adamw(1e-3)).resident == (name == "gsam")
    with pytest.raises(ValueError):
        make_method(MethodConfig(name="nope"))
    # ported since: the in-step numerics guard
    assert make_method(MethodConfig(guard_update=True)).cfg.guard_update is True
    # ported since: the per-leaf path, masked decay and the sgd epilogue
    assert make_method(MethodConfig(fused_update=False)).cfg.fused_update is False
    assert optim.adamw(1e-3, decay_mask=lambda path: True).fused_spec is None
    assert not FusedExecutor(quad_loss, MethodConfig(), optim.adamw(1e-3),
                             resident=False).resident
    method = make_method(MethodConfig(name="sgd"))
    opt = optim.sgd(0.1)
    state = init_train_state({"w": torch.ones(3)}, opt, method)
    state, _ = method.make_step(quad_loss, opt)(state, {"A": torch.eye(3)})
    np.testing.assert_allclose(state.params.to_tree()["w"].numpy(), 0.9 * np.ones(3))


def test_schedules_match_reference():
    steps = jnp.arange(12)
    for jf, tf in ((joptim.cosine_schedule(3e-3, 10, warmup_steps=2, final_fraction=0.1),
                    optim.cosine_schedule(3e-3, 10, warmup_steps=2, final_fraction=0.1)),
                   (joptim.step_decay_schedule(0.1, [3, 7]),
                    optim.step_decay_schedule(0.1, [3, 7])),
                   (joptim.constant_schedule(0.5), optim.constant_schedule(0.5))):
        got = [float(tf(torch.tensor(s, dtype=torch.int32))) for s in range(12)]
        np.testing.assert_allclose(got, np.asarray(jax.vmap(jf)(steps)), rtol=1e-6)


# ---------------------------------------------------------------------------
# olmo-1b-reduced: pipeline, remat and attention gradients, trajectory
# ---------------------------------------------------------------------------

BATCH, SEQ, ASCENT_FRACTION, STEPS = 8, 32, 0.25, 6


@pytest.fixture(scope="module")
def reduced():
    jcfg, cfg = jax_get_config("olmo-1b", reduced=True), get_config("olmo-1b", reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _model(cfg, state_dict):
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(state_dict)
    return model


def test_pipeline_batches_are_bit_identical(reduced):
    jcfg, cfg, _, _ = reduced
    kw = dict(global_batch=BATCH, seq_len=SEQ, seed=3, ascent_fraction=ASCENT_FRACTION)
    it = iter(TokenPipeline(cfg, PipelineConfig(**kw), device="cpu"))
    jit_ = iter(JTokenPipeline(jcfg, JPipelineConfig(**kw)))
    try:
        for _ in range(3):
            b, jb = next(it), next(jit_)
            assert b["ascent"]["tokens"].shape == (2, SEQ)
            for sub, jsub in ((b, jb), (b["ascent"], jb["ascent"])):
                for k in ("tokens", "labels"):
                    assert sub[k].dtype == torch.int32
                    np.testing.assert_array_equal(sub[k].numpy(), np.asarray(jsub[k]))
    finally:
        it.close()
        jit_.close()
    pipe = TokenPipeline(cfg, PipelineConfig(**kw, prefetch=0), device="cpu")
    pipe.restore({"step": 2, "seed": 3})
    np.testing.assert_array_equal(pipe.peek()["tokens"].numpy(), np.asarray(jb["tokens"]))


def _launch_counter(monkeypatch):
    """Send CPU attention through the FlashAttention Function, with the
    kernel launch replaced by the plain version (the CUDA kernel has no CPU
    mode); returns the launch count list."""
    calls = []

    def fake_launch(q, k, v, causal, window):
        calls.append(1)
        return ref.flash_attention_plain(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(fa, "_launch", fake_launch)
    monkeypatch.setattr(fa, "flash_attention", lambda q, k, v, *, causal=True, window=None:
                        fa.FlashAttention.apply(q, k, v, causal, window))
    return calls


def test_flash_function_backward_is_the_plain_versions_gradient(monkeypatch):
    calls = _launch_counter(monkeypatch)
    rng = np.random.default_rng(0)
    qkv = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_(True)
           for s in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 8))]
    out = fa.FlashAttention.apply(*qkv, True, None)
    got = torch.autograd.grad((out * out).sum(), qkv)
    assert len(calls) == 1
    expect_out = ref.flash_attention_plain(*qkv, causal=True)
    expect = torch.autograd.grad((expect_out * expect_out).sum(), qkv)
    torch.testing.assert_close(out, expect_out, rtol=0, atol=0)
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat,forwards", [("none", 1), ("full", 2), ("dots", 2)])
def test_remat_gradients_match_jax_and_rerun_the_forward(reduced, monkeypatch, remat,
                                                         forwards):
    """Each remat mode gives the reference's gradients; "full" and "dots"
    rerun every block's forward (and its flash launch) in backward."""
    jcfg, cfg, jparams, sd = reduced
    calls = _launch_counter(monkeypatch)
    cfg = dataclasses.replace(cfg, remat=remat)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    loss, _ = build_model(cfg).loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert len(calls) == forwards * cfg.n_layers
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss_fn,
                                                      has_aux=True))(jparams, jb, None)
    j_sd = params_from_jax(jax.tree.map(np.asarray, j_grads))
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=2e-5)
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), j_sd[name].numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=name)


def _port_fit(cfg, sd, mkw, steps=STEPS):
    ex = FusedExecutor(build_model(cfg).loss_fn,
                       MethodConfig(name="async_sam", rho=0.05,
                                    ascent_fraction=ASCENT_FRACTION, **mkw),
                       optim.make_optimizer("adamw", optim.cosine_schedule(3e-3, steps)))
    state = ex.init_state(_model(cfg, sd), seed=1)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=BATCH, seq_len=SEQ, seed=0,
                                             ascent_fraction=ASCENT_FRACTION, prefetch=0),
                         device="cpu")
    with Engine(ex, pipe) as eng:
        return eng.fit(state, steps)


def _jax_fit(jcfg, jparams, mkw, steps=STEPS):
    ex = JFusedExecutor(jax_build_model(jcfg).loss_fn,
                        JMethodConfig(name="async_sam", rho=0.05,
                                      ascent_fraction=ASCENT_FRACTION, **mkw),
                        joptim.make_optimizer("adamw", joptim.cosine_schedule(3e-3, steps)),
                        mesh=None, fused_update=True, resident=True)
    state = ex.init_state(jparams, jax.random.PRNGKey(1))
    pipe = JTokenPipeline(jcfg, JPipelineConfig(global_batch=BATCH, seq_len=SEQ, seed=0,
                                                ascent_fraction=ASCENT_FRACTION, prefetch=0))
    with JEngine(ex, pipe) as eng:
        return eng.fit(state, steps)


# Both sides compute in fp32 on the same weights and batches; they differ in
# the order of sums (matmuls, norms, the loss's mean), about 1e-7 relative a
# step. Adam normalizes each update by the gradient's own size, so most of
# the state stays that close over six steps: the scalar metrics to 1e-4
# relative, and 99.9% of every buffer's elements to 1e-4 of its max. But an
# element whose gradient sits at that rounding noise can take Adam's step
# (about lr * sign(g)) the other way on the other side: a few weights (3 of
# 98,304 here) end up apart by up to 5e-4 of max|w|, and the moments and the
# ascent gradient follow them, so every element is held to 1e-3 of the max.
# The cosine of two nearly orthogonal ascent gradients (|cos| < 0.1 here)
# carries their own difference, |da|/|a|: 5e-3 absolute.
TRAJ_RTOL, TRAJ_BULK, TRAJ_MAX, COS_ATOL = 1e-4, 1e-4, 1e-3, 5e-3


@pytest.mark.parametrize("mkw", [{}, {"ascent_interval": 2}, {"n_microbatches": 2}],
                         ids=["interval1", "interval2", "micro2"])
def test_async_sam_trajectory_matches_jax(reduced, mkw):
    jcfg, cfg, jparams, sd = reduced
    rep, jrep = _port_fit(cfg, sd, mkw), _jax_fit(jcfg, jparams, mkw)
    assert rep.steps_done == jrep.steps_done == STEPS
    for i, (m, jm) in enumerate(zip(rep.metrics_history, jrep.metrics_history)):
        assert m["tau"] == jm["tau"] and m["perturbed"] == jm["perturbed"], (i, m, jm)
        assert m["ascent_reused"] == jm["ascent_reused"], i
        assert m["perturbed"] == (0.0 if i == 0 else 1.0)
        for k in ("loss", "ascent_loss", "ascent_norm", "grad_norm"):
            if math.isnan(jm[k]):
                assert math.isnan(m[k]) and m["ascent_reused"] == 1.0, (i, k)
            else:
                assert m[k] == pytest.approx(jm[k], rel=TRAJ_RTOL), (i, k, m[k], jm[k])
        assert m["ascent_cosine"] == pytest.approx(jm["ascent_cosine"], abs=COS_ATOL), i
    taus = [m["tau"] for m in rep.metrics_history]
    assert taus == ([1.0, 2.0] * 3 if mkw.get("ascent_interval") == 2 else [1.0] * STEPS)
    st, jst = rep.final_state, jrep.final_state
    pairs = {"w": (st.params, jst.params),
             "mu": (st.opt_state[0].mu, jst.opt_state[0].mu),
             "nu": (st.opt_state[0].nu, jst.opt_state[0].nu),
             "ascent_grad": (st.method_state.ascent_grad, jst.method_state.ascent_grad)}
    for name, (b, jb) in pairs.items():
        got, expect = b.buffers[0].numpy(), np.asarray(jb.buffers[0])
        assert got.shape == expect.shape, name
        diff, scale = np.abs(got - expect), np.abs(expect).max()
        assert np.quantile(diff, 0.999) <= TRAJ_BULK * scale, name
        assert diff.max() <= TRAJ_MAX * scale, (name, diff.max() / scale)
    assert int(st.opt_state[0].step) == int(jst.opt_state[0].step) == STEPS


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_cli_runs_on_cpu_and_the_loss_falls():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--reduced",
         "--device", "cpu", "--method", "async_sam", "--steps", "12", "--batch", "8",
         "--seq", "32", "--log-every", "1"],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    losses = [float(x) for x in re.findall(r"^step +\d+ +\{'loss': '([0-9.]+)'",
                                            proc.stdout, re.M)]
    assert len(losses) == 12
    assert losses[-1] < losses[0], losses
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-2].removeprefix("kernel launches: ")) == {
        "flash_attention": 0, "sq_norm": 0, "sam_perturb": 0, "fused_axpy": 0,
        "fused_dot_norms": 0, "adamw_epilogue": 0, "sgd_epilogue": 0}
    summary = json.loads(lines[-1])
    assert summary["steps"] == 12 and summary["executor"] == "fused"
    assert summary["mean_step_s"] > 0 and summary["tokens_per_s"] > 0


def test_train_cli_defaults_to_cuda(monkeypatch):
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "olmo-1b", "--reduced",
                                      "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main()


def test_bf16_params_carry_an_fp32_ascent_gradient():
    """A bf16 bucket takes bf16 gradients (as the reference's do) and the
    carried ascent gradient is fp32; the step agrees with the reference."""
    A = _quad_A()

    def loss_bf16(params, batch, gen):
        w = params["w"].float()
        return 0.5 * w @ batch["A"] @ w, {}

    def jax_loss_bf16(params, batch, rng):
        w = params["w"].astype(jnp.float32)
        return 0.5 * w @ batch["A"] @ w, {}

    method = make_method(MethodConfig(name="async_sam", rho=RHO, ascent_fraction=1.0))
    opt = optim.adamw(LR)
    state = init_train_state({"w": torch.tensor(W0, dtype=torch.bfloat16)}, opt, method)
    step = method.make_step(loss_bf16, opt)
    jmethod = jax_make_method(JMethodConfig(name="async_sam", rho=RHO, ascent_fraction=1.0))
    jopt = joptim.adamw(LR)
    jex = JFusedExecutor(jax_loss_bf16, jmethod, jopt, mesh=None, fused_update=True,
                         resident=True)
    jstate = jex.init_state({"w": jnp.asarray(W0, jnp.bfloat16)}, jax.random.PRNGKey(1))
    for _ in range(3):
        state, _ = step(state, {"A": torch.tensor(A, dtype=torch.float32)})
        jstate, _ = jex.step(jstate, {"A": jnp.asarray(A, jnp.float32)})
    assert state.params.buffers[0].dtype == torch.bfloat16
    assert state.method_state.ascent_grad.buffers[0].dtype == torch.float32
    np.testing.assert_allclose(state.params.buffers[0].float().numpy(),
                               np.asarray(jstate.params.buffers[0], np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(state.method_state.ascent_grad.buffers[0].numpy(),
                               np.asarray(jstate.method_state.ascent_grad.buffers[0]),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("t_fast,t_slow", [(1.0, 4.0), (1.0, 100.0), (3.0, 1.0), (0.0, 1.0)])
def test_system_aware_ascent_fraction_matches_reference(t_fast, t_slow):
    from repro.core import system_aware_ascent_fraction as jax_fraction
    from repro_torch.core import system_aware_ascent_fraction
    assert system_aware_ascent_fraction(t_fast, t_slow) == jax_fraction(t_fast, t_slow)
