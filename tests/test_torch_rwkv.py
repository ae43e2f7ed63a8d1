"""Port parity for the rwkv6 family (rwkv6-7b, reduced): the wkv scan's plain
version and its gradient, the autograd Function around the kernels, the
model (forward, prefill + decode), its buckets and weights, a Form A
AsyncSAM AdamW trajectory, the launchers and checkpoints, each against the
JAX package on the same inputs and the same (converted) weights.

Every tensor here lies on the CPU, so the port runs its plain versions; the
Function's plumbing is driven with the plain versions standing in for the
kernels (the CUDA kernels have no CPU mode: tests/test_torch_cuda.py holds
them against the plain versions on the card).
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
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.core import MethodConfig as JMethodConfig
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.engine import Engine as JEngine
from repro.engine import FusedExecutor as JFusedExecutor
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_chunked
from repro.models import build_model as jax_build_model
from repro.utils import buckets as jbuckets
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import Engine, FusedExecutor
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as r6
from repro_torch.models import analytic_param_count, build_model, synth_batch, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import buckets

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "rwkv6-7b"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_max(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced_", [False, True])
def test_config_and_param_count_match_reference(reduced_):
    cfg, jcfg = get_config(ARCH, reduced=reduced_), jax_get_config(ARCH, reduced=reduced_)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert analytic_param_count(cfg) == cfg.param_count() == jcfg.param_count()
    if not reduced_:
        assert analytic_param_count(cfg) == 7_534_813_184
        four = dataclasses.replace(cfg, n_layers=4)
        assert analytic_param_count(four) == 1_411_620_864


# ---------------------------------------------------------------------------
# the wkv scan: plain version against the oracle and the Pallas kernel
# ---------------------------------------------------------------------------

def _wkv_inputs(b, s, h, dk, dv, seed=0, w_scale=0.5):
    """The reference tests' distributions, drawn with numpy: r, k, v ~ 0.5
    N(0, 1), the log decay w = -exp(w_scale N(0, 1) - 2), u ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32) * 0.5 for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32) * 0.5
    w = -np.exp(rng.standard_normal((b, s, h, dk)).astype(np.float32) * w_scale - 2.0)
    u = rng.standard_normal((h, dk)).astype(np.float32) * 0.1
    return r, k, v, w.astype(np.float32), u


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# the reference's own sweep (tests/test_kernels.py: S 64/128 with chunk
# 16/32, K = V 16/32); fp32 throughout, within 1e-5 as there
@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32)])
@pytest.mark.parametrize("dk,dv", [(16, 16), (32, 32)])
def test_plain_scan_matches_oracle_and_pallas_interpret(s, chunk, dk, dv):
    ins = _wkv_inputs(2, s, 2, dk, dv)
    y, state = ref.rwkv6_scan_plain(*_t(*ins))
    jins = [jnp.asarray(a) for a in ins]
    y_o, s_o = jax.jit(jref.rwkv6_scan_ref)(*jins)
    y_k, s_k = rwkv6_chunked(*jins, chunk=chunk, interpret=True)
    assert y.dtype == torch.float32 and state.shape == (2, 2, dk, dv)
    for expect_y, expect_s in ((y_o, s_o), (y_k, s_k)):
        np.testing.assert_allclose(_np(y), _np(expect_y), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(state), _np(expect_s), rtol=1e-5, atol=1e-5)


def test_plain_scan_state_continuation():
    """Two halves, the second from the first's state, give the whole scan
    (tests/test_kernels.py:285-298), and the oracle's values."""
    r, k, v, w, u = _t(*_wkv_inputs(1, 64, 2, 8, 8, seed=1, w_scale=0.3))
    y_full, s_full = ref.rwkv6_scan_plain(r, k, v, w, u)
    y1, s1 = ref.rwkv6_scan_plain(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u)
    y2, s2 = ref.rwkv6_scan_plain(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u,
                                  init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, s_full, rtol=1e-5, atol=1e-5)
    j1 = jref.rwkv6_scan_ref(*(jnp.asarray(t[:, :32].numpy()) for t in (r, k, v, w)),
                             jnp.asarray(u.numpy()))
    j2 = jref.rwkv6_scan_ref(*(jnp.asarray(t[:, 32:].numpy()) for t in (r, k, v, w)),
                             jnp.asarray(u.numpy()), init_state=j1[1])
    np.testing.assert_allclose(_np(y2), _np(j2[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s2), _np(j2[1]), rtol=1e-5, atol=1e-5)


def test_plain_scan_bf16_inputs_match_oracle():
    """bf16 r/k/v: fp32 math, y rounded once to bf16 (the oracle's
    .astype(r.dtype)); the state stays fp32."""
    r, k, v, w, u = _wkv_inputs(2, 48, 2, 16, 16, seed=2)
    rb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (r, k, v))
    y, state = ref.rwkv6_scan_plain(rb, kb, vb, *_t(w, u))
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (rb, kb, vb)]
    y_o, s_o = jax.jit(jref.rwkv6_scan_ref)(*jb, jnp.asarray(w), jnp.asarray(u))
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert _rel_max(state, s_o) <= 1e-5
    np.testing.assert_allclose(_np(y), _np(y_o), rtol=2e-2, atol=2e-2)


# (init_state, cotangents, dtype): every gradient within 1e-4 of its own
# max (fp32: the sums' order); bf16 r/k/v: dr, dk, dv round once to bf16
GRAD_CASES = [(False, "both", "float32"), (True, "both", "float32"),
              (True, "dy", "float32"), (True, "d_state", "float32"),
              (True, "both", "bfloat16")]


@pytest.mark.parametrize("init,cotangents,dtype", GRAD_CASES)
def test_plain_backward_matches_jax_grad(init, cotangents, dtype):
    b, s, h, dk, dv = 2, 40, 2, 16, 16
    r, k, v, w, u = _wkv_inputs(b, s, h, dk, dv, seed=3)
    w[..., 0] = -200.0                       # a channel whose exp(w) underflows to 0
    rng = np.random.default_rng(4)
    s0 = rng.standard_normal((b, h, dk, dv)).astype(np.float32) if init else None
    dy = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    ds = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    dy = None if cotangents == "d_state" else dy
    ds = None if cotangents == "dy" else ds
    tdt = getattr(torch, dtype)
    tr, tk, tv = (torch.from_numpy(a).to(tdt) for a in (r, k, v))
    got = ref.rwkv6_scan_plain_grads(
        tr, tk, tv, *_t(w, u), None if s0 is None else torch.from_numpy(s0),
        None if dy is None else torch.from_numpy(dy).to(tdt),
        None if ds is None else torch.from_numpy(ds))

    jdt = jnp.dtype(dtype)
    jr, jk, jv = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (tr, tk, tv))
    js0 = jnp.zeros((b, h, dk, dv), jnp.float32) if s0 is None else jnp.asarray(s0)

    def loss(r_, k_, v_, w_, u_, s0_):
        y_, st_ = jref.rwkv6_scan_ref(r_, k_, v_, w_, u_, init_state=s0_)
        out = jnp.float32(0.0)
        if dy is not None:
            out += jnp.sum(y_.astype(jnp.float32)
                           * jnp.asarray(dy).astype(jdt).astype(jnp.float32))
        if ds is not None:
            out += jnp.sum(st_ * jnp.asarray(ds))
        return out

    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        jr, jk, jv, jnp.asarray(w), jnp.asarray(u), js0)
    for name, g, e in zip(("dr", "dk", "dv", "dw", "du", "d_init"), got, want):
        assert tuple(g.shape) == e.shape, name
        assert str(g.dtype).removeprefix("torch.") == str(e.dtype), name
        tol = 1e-4 if (dtype == "float32" or name in ("dw", "du", "d_init")) else 1e-2
        assert _rel_max(g, e) <= tol, (name, _rel_max(g, e))


def _one_carry_backward(r, k, v, w, u, s0, dy, ds):
    """The CUDA backward's algebra in float64 (numpy arrays in; s0, dy, ds
    may be None): pass 1 rebuilds S forward from s0 and keeps p_t = S_{t-1}
    dy_t; pass 2 runs one G recurrence backward from ds, G_{t-1} = exp(w_t) G_t
    + r_t dy_t^T, with q_T = sum_j G_T S_T, dw_t = q_t - k_t (G_t v_t), q_{t-1}
    = dw_t + r_t p_t (no division by a decay), and dv_t = G_t^T k_t + dy_t
    sum_i r u k as a column sum of the one G. Returns (dr, dk, dv, dw, du,
    d_init_state) as numpy arrays."""
    f64 = torch.float64
    r, k, v, w, u = (torch.from_numpy(np.asarray(a)).to(f64) for a in (r, k, v, w, u))
    b, s, h, dk_ = r.shape
    dv_ = v.shape[-1]
    dy = torch.zeros((b, s, h, dv_), dtype=f64) if dy is None else torch.from_numpy(dy).to(f64)
    st = torch.zeros((b, h, dk_, dv_), dtype=f64) if s0 is None else torch.from_numpy(s0).to(f64)
    ew = torch.exp(w)
    p = torch.empty_like(r)
    for t in range(s):                                    # pass 1
        p[:, t] = torch.einsum("bhij,bhj->bhi", st, dy[:, t])
        st = ew[:, t, :, :, None] * st + k[:, t, :, :, None] * v[:, t, :, None, :]
    g = torch.zeros_like(st) if ds is None else torch.from_numpy(ds).to(f64)
    q = (g * st).sum(-1)
    grads = [torch.empty_like(r), torch.empty_like(k), torch.empty_like(v), torch.empty_like(w)]
    du = torch.zeros_like(u)
    for t in reversed(range(s)):                          # pass 2: one G recurrence
        rt, kt, vt, gt = r[:, t], k[:, t], v[:, t], dy[:, t]
        gv = torch.einsum("bhij,bhj->bhi", g, vt)         # row sums
        dyv = (gt * vt).sum(-1, keepdim=True)
        bonus = (rt * u * kt).sum(-1, keepdim=True)
        dwt = q - kt * gv
        grads[0][:, t] = p[:, t] + u * kt * dyv
        grads[1][:, t] = gv + rt * u * dyv
        grads[2][:, t] = torch.einsum("bhij,bhi->bhj", g, kt) + gt * bonus   # column sums
        grads[3][:, t] = dwt
        q = dwt + rt * p[:, t]
        du += (rt * kt * dyv).sum(0)
        g = ew[:, t, :, :, None] * g + rt[..., None] * gt[..., None, :]
    return tuple(t.numpy() for t in (*grads, du, g))


def _wkv_f64_grads(r, k, v, w, u, s0, dy, ds):
    """Autograd of the recurrence itself in float64: the exact gradient the
    one-carry rendition must reach."""
    f64 = torch.float64
    ins = [torch.from_numpy(np.asarray(a)).to(f64).requires_grad_(True)
           for a in (r, k, v, w, u, np.zeros((r.shape[0], r.shape[2], r.shape[3], v.shape[-1]))
                     if s0 is None else s0)]
    rt, kt, vt, wt, ut, st = ins
    ys = []
    for t in range(r.shape[1]):
        kv = kt[:, t, :, :, None] * vt[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rt[:, t], st + ut[None, :, :, None] * kv))
        st = torch.exp(wt[:, t, :, :, None]) * st + kv
    loss = torch.zeros((), dtype=f64)
    if dy is not None:
        loss = loss + (torch.stack(ys, 1) * torch.from_numpy(dy).to(f64)).sum()
    if ds is not None:
        loss = loss + (st * torch.from_numpy(ds).to(f64)).sum()
    got = torch.autograd.grad(loss, ins, allow_unused=True)
    return [np.zeros(t.shape) if g is None else g.numpy() for g, t in zip(got, ins)]


# (K = V, init_state, cotangents): the reduced config's 16 and the model's 64,
# with and without an initial state, from dy, from the final state's
# cotangent and from both
ONE_CARRY_CASES = [(n, init, cot) for n in (16, 64) for init in (True, False)
                   for cot in ("both", "dy", "d_state")]


@pytest.mark.parametrize("n,init,cotangents", ONE_CARRY_CASES)
def test_one_carry_backward_matches_jax_grad(n, init, cotangents):
    """The CUDA backward's algebra (one G recurrence; dv a column sum of it;
    dw through q, never divided by exp(w)), rendered in float64 by
    _one_carry_backward, with a channel whose exp(w) underflows to 0: within
    1e-10 of autograd of the recurrence in float64, and within the plain
    backward's limit of 1e-4 (the oracle's fp32 sums) of jax.grad of the
    oracle `rwkv6_scan_ref` on the same inputs."""
    b, s, h = 2, 33, 2
    r, k, v, w, u = _wkv_inputs(b, s, h, n, n, seed=7)
    w[..., 0] = -200.0
    rng = np.random.default_rng(8)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32) if init else None
    dy = None if cotangents == "d_state" else rng.standard_normal((b, s, h, n)).astype(np.float32)
    ds = None if cotangents == "dy" else rng.standard_normal((b, h, n, n)).astype(np.float32)
    got = _one_carry_backward(r, k, v, w, u, s0, dy, ds)
    exact = _wkv_f64_grads(r, k, v, w, u, s0, dy, ds)

    def loss(r_, k_, v_, w_, u_, s0_):
        y_, st_ = jref.rwkv6_scan_ref(r_, k_, v_, w_, u_, init_state=s0_)
        out = jnp.float32(0.0)
        if dy is not None:
            out += jnp.sum(y_ * jnp.asarray(dy))
        if ds is not None:
            out += jnp.sum(st_ * jnp.asarray(ds))
        return out

    js0 = jnp.zeros((b, h, n, n), jnp.float32) if s0 is None else jnp.asarray(s0)
    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *(jnp.asarray(a) for a in (r, k, v, w, u)), js0)
    for name, g, x64, e in zip(("dr", "dk", "dv", "dw", "du", "d_init"), got, exact, want):
        e = np.asarray(e)
        assert g.shape == e.shape and np.isfinite(g).all(), name
        if not e.any():                          # no path from the given cotangent
            assert not g.any() and not x64.any(), name
            continue
        assert _rel_max(g, x64) <= 1e-10, (name, _rel_max(g, x64))
        assert _rel_max(g, e) <= 1e-4, (name, _rel_max(g, e))


def _blocked_forward(r, k, v, w, u, s0, dtype):
    """The CUDA forward's arithmetic in numpy at `dtype` (numpy arrays in; s0
    may be None): K and V zero-padded to N (16, 32 or 64), the rows of S in
    8 row groups (group g holds rows g + 8 m), each group's partial of y_t[j]
    summed over its rows in order, the bonus folded in as v_t[j] times the
    group's sum of r u k, the 8 partials added in the kernel's exchange
    order ((g, g + 4), then (g, g + 2), then (g, g + 1)), then S updated as
    exp(w) S + k v^T. Returns (y (B,S,H,V), final state (B,H,K,V))."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    n = next(x for x in (16, 32, 64) if max(dk, dv) <= x)

    def pad(a, width, fill=0.0):
        out = np.full(a.shape[:-1] + (width,), fill, dtype)
        out[..., :a.shape[-1]] = a
        return out

    rp, kp, vp = pad(r, n), pad(k, n), pad(v, n)
    ew = np.exp(pad(w, n, -np.inf))
    up = pad(u, n)
    st = np.zeros((b, h, n, n), dtype)
    if s0 is not None:
        st[:, :, :dk, :dv] = s0
    ys = []
    for t in range(s):
        rt, kt, vt = rp[:, t], kp[:, t], vp[:, t]                 # (B, H, N)
        ruk = rt * up * kt
        rows = st.reshape(b, h, n // 8, 8, n)                      # [m][g] = row g + 8 m
        part = np.zeros((b, h, 8, n), dtype)
        bonus = np.zeros((b, h, 8), dtype)
        for m in range(n // 8):
            part = part + rt.reshape(b, h, n // 8, 8)[:, :, m, :, None] * rows[:, :, m]
            bonus = bonus + ruk.reshape(b, h, n // 8, 8)[:, :, m]
        part = part + vt[:, :, None, :] * bonus[..., None]
        part = part[:, :, :4] + part[:, :, 4:]
        part = part[:, :, :2] + part[:, :, 2:]
        ys.append((part[:, :, 0] + part[:, :, 1])[..., :dv])
        st = ew[:, t][..., None] * st + kt[..., None] * vt[..., None, :]
    return np.stack(ys, 1), st[:, :, :dk, :dv]


def _wkv_f64_forward(r, k, v, w, u, s0):
    """The recurrence itself in float64: (y, final state)."""
    r, k, v, w, u = (np.asarray(a, np.float64) for a in (r, k, v, w, u))
    st = (np.zeros(r.shape[:1] + r.shape[2:] + v.shape[-1:]) if s0 is None
          else np.asarray(s0, np.float64))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(np.einsum("bhi,bhij->bhj", r[:, t], st + u[None, :, :, None] * kv))
        st = np.exp(w[:, t])[..., None] * st + kv
    return np.stack(ys, 1), st


# (K, V, init_state): the reduced config's 16 and the model's 64 with and
# without an initial state, and K != V (padded to 64)
BLOCKED_CASES = [(16, 16, True), (16, 16, False), (64, 64, True), (64, 64, False),
                 (24, 40, False)]


@pytest.mark.parametrize("dk,dv,init", BLOCKED_CASES)
def test_blocked_forward_matches_recurrence_oracle_and_pallas(dk, dv, init):
    """The CUDA forward's blocked order (row-group partials, their fixed-order
    sum, the bonus folded in), rendered by _blocked_forward at S = 33 (not a
    multiple of the kernel's 16-step chunk) with a channel whose exp(w)
    underflows to 0: in float64 within 1e-10 of the recurrence in float64;
    in fp32 within 1e-5 of the max of the oracle `rwkv6_scan_ref` and of the
    Pallas kernel in interpret mode (chunk 11; from a state the reference
    itself takes its oracle)."""
    b, s, h = 2, 33, 2
    r, k, v, w, u = _wkv_inputs(b, s, h, dk, dv, seed=9)
    w[..., 0] = -200.0
    rng = np.random.default_rng(10)
    s0 = rng.standard_normal((b, h, dk, dv)).astype(np.float32) if init else None
    y64, st64 = _blocked_forward(r, k, v, w, u, s0, np.float64)
    y_x, st_x = _wkv_f64_forward(r, k, v, w, u, s0)
    assert _rel_max(y64, y_x) <= 1e-10 and _rel_max(st64, st_x) <= 1e-10
    y32, st32 = _blocked_forward(r, k, v, w, u, s0, np.float32)
    assert y32.dtype == st32.dtype == np.float32 and np.isfinite(y32).all()
    jins = [jnp.asarray(a) for a in (r, k, v, w, u)]
    js0 = None if s0 is None else jnp.asarray(s0)
    want = [jax.jit(jref.rwkv6_scan_ref)(*jins, init_state=js0),
            rwkv6_chunked(*jins, chunk=11, init_state=js0, interpret=True)]
    for y_e, st_e in want:
        assert _rel_max(y32, y_e) <= 1e-5, _rel_max(y32, y_e)
        assert _rel_max(st32, st_e) <= 1e-5, _rel_max(st32, st_e)


def test_reference_cannot_differentiate_its_pallas_kernel():
    """The reference's fault: jax.grad through `rwkv6_chunked` (interpret
    mode, the path its TPU training would take) raises AssertionError on
    jax 0.9.0, so it differentiates only its oracle; the port's backward is
    a kernel of its own, held against jax.grad of the oracle."""
    r, k, v, w, u = (jnp.asarray(a) for a in _wkv_inputs(1, 32, 2, 16, 16, seed=5))
    with pytest.raises(AssertionError):
        jax.grad(lambda r_: rwkv6_chunked(r_, k, v, w, u, chunk=16,
                                          interpret=True)[0].sum())(r)


# ---------------------------------------------------------------------------
# the autograd Function, with the plain versions standing in for the kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_kernels(monkeypatch):
    """Route CPU calls through `RWKV6Scan`, its launches replaced by the
    plain versions; returns the calls' arguments."""
    calls = {"fwd": [], "bwd": []}

    def fwd(r, k, v, w, u, init_state):
        calls["fwd"].append(init_state is not None)
        with torch.no_grad():
            return ref.rwkv6_scan_plain(r, k, v, w, u, init_state)

    def bwd(r, k, v, w, u, init_state, dy, d_state):
        calls["bwd"].append((dy is not None, d_state is not None))
        return ref.rwkv6_scan_plain_grads(r, k, v, w, u, init_state, dy, d_state)

    monkeypatch.setattr(r6, "_launch_fwd", fwd)
    monkeypatch.setattr(r6, "_launch_bwd", bwd)
    monkeypatch.setattr(r6, "rwkv6_scan", lambda r, k, v, w, u, init_state=None:
                        r6.RWKV6Scan.apply(r, k, v, w, u, init_state))
    return calls


@pytest.mark.parametrize("init", [False, True])
def test_function_gradients_are_the_plain_versions(fake_kernels, init):
    ins = _t(*_wkv_inputs(2, 24, 2, 16, 16, seed=6))
    if init:
        ins.append(torch.from_numpy(np.random.default_rng(7).standard_normal(
            (2, 2, 16, 16)).astype(np.float32)))
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y, state = r6.rwkv6_scan(*leaves)
    loss = (y * y.cos()).sum() + (state * state).sum()
    got = torch.autograd.grad(loss, leaves)
    assert fake_kernels == {"fwd": [init], "bwd": [(True, True)]}
    plain = [t.clone().requires_grad_(True) for t in ins]
    y_p, state_p = ref.rwkv6_scan_plain(*plain)
    want = torch.autograd.grad((y_p * y_p.cos()).sum() + (state_p * state_p).sum(), plain)
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-6)


def test_function_passes_a_missing_cotangent_as_none(fake_kernels):
    """Only y reaches the loss: the state's cotangent is None, not a zero
    tensor (the kernel reads none); the init state gets no gradient when
    none was given."""
    leaves = [t.requires_grad_(True) for t in _t(*_wkv_inputs(1, 8, 2, 16, 16, seed=8))]
    y, _ = r6.rwkv6_scan(*leaves)
    y.sum().backward()
    assert fake_kernels["bwd"] == [(True, False)]
    assert all(t.grad is not None for t in leaves)


@pytest.mark.parametrize("remat,forwards", [("none", 1), ("full", 2), ("dots", 2)])
def test_remat_gradients_match_jax_and_rerun_the_scan(fake_kernels, remat, forwards):
    """Each remat mode gives the reference's gradients; "full" and "dots"
    rerun every block's forward (and its scan launch) in backward, and the
    backward kernel runs once per block."""
    jcfg, cfg = jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree.map(np.asarray, jparams))
    cfg = dataclasses.replace(cfg, remat=remat)
    batch = synth_batch(cfg, 2, 32, seed=1, device="cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    loss, _ = build_model(cfg).loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert len(fake_kernels["fwd"]) == forwards * cfg.n_layers
    assert len(fake_kernels["bwd"]) == cfg.n_layers
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss_fn,
                                                      has_aux=True))(jparams, jb, None)
    j_sd = params_from_jax(jax.tree.map(np.asarray, j_grads))
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=2e-5)
    # fp32 on both sides, sums in another order: each gradient within 1e-4 of
    # its own max (an elementwise rtol fails on the near-zero elements)
    worst = {name: _rel_max(g, j_sd[name]) for name, g in zip(params, grads)}
    assert max(worst.values()) <= 1e-4, worst


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    ins = _t(*_wkv_inputs(1, 6, 2, 16, 16, seed=9))
    before = dict(r6.launches)
    y, state = ops.rwkv6_mix(*ins)
    y_p, state_p = ref.rwkv6_scan_plain(*ins)
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    torch.testing.assert_close(state, state_p, rtol=0, atol=0)
    assert r6.launches == before
    with pytest.raises(ValueError):
        ops.rwkv6_mix(*ins, impl="pallas")


# ---------------------------------------------------------------------------
# the model: JAX init -> params_from_jax -> port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    jcfg, cfg = jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, sd


def _model(cfg, sd):
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(sd)
    return model


def test_state_dict_names_mirror_jax_leaves(reduced):
    jcfg, cfg, jparams, sd = reduced
    model = _model(cfg, sd)
    names = set(model.state_dict())
    assert names == set(sd)
    assert {"embedding.embed", "embedding.unembed", "final_norm.scale", "final_norm.bias",
            "blocks.0.ln1.bias", "blocks.1.tm.wr", "blocks.0.tm.bonus_u",
            "blocks.1.cm.wk_c"} <= names
    assert len(names) == 4 + cfg.n_layers * (4 + 15 + 5)


def test_init_draws_the_reference_distributions():
    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg, n_layers=2, d_model=256, d_ff=512, vocab_size=128,
                              rwkv=dataclasses.replace(cfg.rwkv, decay_lora_rank=16))
    model = transformer.init_params(cfg, seed=0, device="cpu").requires_grad_(False)
    tm, cm = model.blocks[1].tm, model.blocks[1].cm
    for mix in (tm.mix_r, tm.mix_k, tm.mix_v, tm.mix_w, tm.mix_g, cm.mix_k, cm.mix_r):
        assert bool((mix == 0.5).all())
    assert bool((tm.w0 == -2.0).all()) and bool((tm.ln_scale == 1.0).all())
    assert bool((model.blocks[0].ln1.bias == 0.0).all())
    assert abs(float(tm.bonus_u.std()) - 0.1) < 0.02
    d = cfg.d_model
    assert abs(float(tm.wr.std()) * d ** 0.5 - 0.88) < 0.05       # truncated N(0,1)
    assert abs(float(tm.decay_b.std()) * 16 ** 0.5 / 0.1 - 0.88) < 0.1
    assert abs(float(tm.wo.std()) * d ** 0.5 * 2 - 0.88) < 0.05    # 1/sqrt(2 L)
    assert float(model.embedding.unembed.abs().max()) <= 2.0 / d ** 0.5 + 1e-6


def _slice_parity(jcfg, cfg, jparams, model, rel_tol, check_tokens):
    """forward, prefill (and its cache) and stepwise decode against the
    reference (the check of tests/test_serving.py, on both packages)."""
    jb = jax_build_model(jcfg)
    S, n_dec = 12, 4
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, S + n_dec),
                                               dtype=np.int32)
    j_full, _ = jax.jit(jb.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        full, aux = transformer.forward(model, {"tokens": torch.from_numpy(tokens)}, cfg)
    scale = float(np.abs(_np(j_full)).max())
    assert float(aux) == 0.0 and full.dtype == getattr(torch, cfg.compute_dtype)
    assert np.abs(_np(full) - _np(j_full)).max() <= rel_tol * scale

    prompt = tokens[:, :S]
    j_logits, j_cache = jax.jit(lambda p, b: jb.prefill(p, b, pad_to=S + n_dec))(
        jparams, {"tokens": jnp.asarray(prompt)})
    with torch.inference_mode():
        logits, cache = transformer.prefill(model, {"tokens": torch.from_numpy(prompt)},
                                            cfg, pad_to=S + n_dec)
    assert cache["pos"] == int(j_cache["pos"]) == S
    assert sorted(cache["layers"]) == sorted(j_cache["layers"]) == ["cm_shift", "tm_shift",
                                                                     "wkv"]
    for name, t in cache["layers"].items():
        jt = j_cache["layers"][name]
        assert tuple(t.shape) == jt.shape and str(t.dtype).removeprefix("torch.") == str(
            jt.dtype), name
        assert np.abs(_np(t) - _np(jt)).max() <= rel_tol * max(np.abs(_np(jt)).max(), 1.0)
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
    return full, tokens


def test_rwkv_reduced_forward_prefill_decode_match_jax(reduced):
    """fp32 compute: within 2e-5 of the logits' max."""
    jcfg, cfg, jparams, sd = reduced
    _slice_parity(jcfg, cfg, jparams, _model(cfg, sd), rel_tol=2e-5, check_tokens=True)


def test_rwkv_reduced_bf16_compute_matches_jax(reduced):
    """Same (fp32) weights, bf16 compute on both sides: within 2e-2."""
    jcfg, cfg, jparams, sd = reduced
    _slice_parity(dataclasses.replace(jcfg, compute_dtype="bfloat16"),
                  dataclasses.replace(cfg, compute_dtype="bfloat16"), jparams,
                  _model(cfg, sd), rel_tol=2e-2, check_tokens=False)


def test_prefill_decode_matches_full_forward(reduced):
    """The port alone: prefill + one-token decode steps == one forward."""
    _, cfg, _, sd = reduced
    model = _model(cfg, sd)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 20),
                                                                dtype=np.int32))
    with torch.inference_mode():
        full, _ = transformer.forward(model, {"tokens": tokens}, cfg)
        logits, cache = transformer.prefill(model, {"tokens": tokens[:, :15]}, cfg)
        errs = [_rel_max(logits[:, -1], full[:, 14])]
        for t in range(15, 20):
            logits, cache = transformer.decode(model, cache, {"tokens": tokens[:, t:t + 1]},
                                               cfg)
            errs.append(_rel_max(logits[:, 0], full[:, t]))
    assert max(errs) <= 2e-5, errs


def test_init_cache_matches_reference_structure():
    cfg, jcfg = get_config(ARCH, reduced=True), jax_get_config(ARCH, reduced=True)
    jc = jax_build_model(jcfg).init_cache(2, 10, pos=3)
    c = transformer.init_cache(cfg, 2, 10, pos=3, device="cpu")
    assert c["pos"] == int(jc["pos"]) == 3
    assert sorted(c["layers"]) == sorted(jc["layers"])
    for name, t in c["layers"].items():
        assert tuple(t.shape) == jc["layers"][name].shape and not t.any()
        assert str(t.dtype).removeprefix("torch.") == str(jc["layers"][name].dtype)


def test_loss_fn_matches_jax(reduced):
    jcfg, cfg, jparams, sd = reduced
    batch = synth_batch(cfg, 2, 10, seed=3, device="cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    j_loss, _ = jax.jit(jax_build_model(jcfg).loss_fn)(jparams, jbatch, jax.random.PRNGKey(0))
    with torch.inference_mode():
        loss, _ = build_model(cfg).loss_fn(_model(cfg, sd), batch)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=2e-5)


# ---------------------------------------------------------------------------
# buckets and weights
# ---------------------------------------------------------------------------

def test_bucket_layout_and_buffer_are_the_reference_bitwise(reduced):
    """The flat parameter buffer is the reference's, in its flatten order
    (blocks/{cm,ln1,ln2,tm}/* stacked on L), bit for bit."""
    _, cfg, jparams, sd = reduced
    model = _model(cfg, sd)
    jl = jbuckets.bucket_layout(jparams)
    layout = buckets.bucket_layout(dict(model.named_parameters()))
    assert len(layout.groups) == len(jl.groups) == 1
    spans = []
    for name, off, size in zip(layout.groups[0].names, layout.groups[0].offsets,
                               layout.groups[0].sizes):
        key = buckets.flatten_key(name)[0]
        if spans and spans[-1][0] == key:
            spans[-1][2] += size
        else:
            spans.append([key, off, size])
    assert [(o, s) for _, o, s in spans] == list(zip(jl.groups[0].offsets,
                                                     jl.groups[0].sizes))
    assert spans[0][0] == ("blocks", "cm", "mix_k")
    jstate = jbuckets.BucketedState.from_tree(jparams)
    state = buckets.BucketedState.from_tree(dict(model.named_parameters()))
    np.testing.assert_array_equal(state.buffers[0].detach().numpy(),
                                  np.asarray(jstate.buffers[0]))


def test_params_from_jax_round_trips_the_tree(reduced):
    from repro_torch.models.convert import to_reference
    _, cfg, jparams, sd = reduced
    tree = to_reference(sd, leaf=lambda t: t.numpy())
    jtree = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Form A AsyncSAM AdamW trajectory
# ---------------------------------------------------------------------------

BATCH, SEQ, ASCENT_FRACTION, STEPS = 8, 32, 0.25, 6
# The argument of tests/test_torch_train.py: both sides compute in fp32 on
# the same weights and batches and differ in the order of sums; Adam
# normalizes each update, so a weight whose gradient sits at that rounding
# noise can take its step (about lr) the other way, and the rest of the
# state follows what such weights change. Reduced rwkv6 is far more
# sensitive to both than olmo:
# * its gradients at the init differ from the reference's by up to 1.2e-5
#   of a leaf's max (the reference's own jit and op-by-op gradients by up to
#   4e-6; olmo's by ~1e-7);
# * the per-channel token-shift mixes, each shared by every token, are such
#   weights: at olmo's lr 3e-3 one of them (blocks.0.tm.mix_g[16]) flips at
#   step 0 and moves the step-1 ascent norm by 2.5e-3, and the model is
#   chaotic at that lr in the reference itself (one embedding element moved
#   by one ulp moves its step-4 ascent norm by 1.4%).
# So the trajectory runs at lr 3e-5, where a flip moves a weight 100x less
# (chip_smoke.py's whole-path check runs at it for the same reason). There
# the scalar metrics stay within 1e-4 relative (measured 6.8e-5) and w as
# olmo's (99.9% within 1e-4 of max|w|, every element within 1e-3; measured
# 3.4e-8 and 4.0e-5), while the gradients the moments and the ascent buffer
# hold carry the sensitivity above: 99.9% within 1e-3 of the max, every
# element within 5e-3 (measured 4.1e-4 and 1.3e-3, the ascent gradient's).
# The cosine of nearly orthogonal ascent gradients carries their own
# difference (5e-3 absolute).
TRAJ_LR, TRAJ_RTOL, COS_ATOL = 3e-5, 1e-4, 5e-3
TRAJ_BULK = {"w": 1e-4, "mu": 1e-3, "nu": 1e-3, "ascent_grad": 1e-3}
TRAJ_MAX = {"w": 1e-3, "mu": 5e-3, "nu": 5e-3, "ascent_grad": 5e-3}


def test_async_sam_trajectory_matches_jax(reduced):
    jcfg, cfg, jparams, sd = reduced
    mcfg = dict(name="async_sam", rho=0.05, ascent_fraction=ASCENT_FRACTION)
    pkw = dict(global_batch=BATCH, seq_len=SEQ, seed=0, ascent_fraction=ASCENT_FRACTION,
               prefetch=0)
    ex = FusedExecutor(build_model(cfg).loss_fn, MethodConfig(**mcfg),
                       optim.make_optimizer("adamw", optim.cosine_schedule(TRAJ_LR, STEPS)))
    with Engine(ex, TokenPipeline(cfg, PipelineConfig(**pkw), device="cpu")) as eng:
        rep = eng.fit(ex.init_state(_model(cfg, sd), seed=1), STEPS)
    jex = JFusedExecutor(jax_build_model(jcfg).loss_fn, JMethodConfig(**mcfg),
                         joptim.make_optimizer("adamw", joptim.cosine_schedule(TRAJ_LR, STEPS)),
                         mesh=None, fused_update=True, resident=True)
    with JEngine(jex, JTokenPipeline(jcfg, JPipelineConfig(**pkw))) as eng:
        jrep = eng.fit(jex.init_state(jparams, jax.random.PRNGKey(1)), STEPS)
    assert rep.steps_done == jrep.steps_done == STEPS
    for i, (m, jm) in enumerate(zip(rep.metrics_history, jrep.metrics_history)):
        assert m["tau"] == jm["tau"] == 1.0 and m["perturbed"] == jm["perturbed"], i
        assert m["perturbed"] == (0.0 if i == 0 else 1.0)
        for k in ("loss", "ascent_loss", "ascent_norm", "grad_norm"):
            assert m[k] == pytest.approx(jm[k], rel=TRAJ_RTOL), (i, k, m[k], jm[k])
        assert m["ascent_cosine"] == pytest.approx(jm["ascent_cosine"], abs=COS_ATOL), i
    st, jst = rep.final_state, jrep.final_state
    pairs = {"w": (st.params, jst.params),
             "mu": (st.opt_state[0].mu, jst.opt_state[0].mu),
             "nu": (st.opt_state[0].nu, jst.opt_state[0].nu),
             "ascent_grad": (st.method_state.ascent_grad, jst.method_state.ascent_grad)}
    for name, (b, jb) in pairs.items():
        got, expect = b.buffers[0].numpy(), np.asarray(jb.buffers[0])
        assert got.shape == expect.shape, name
        diff, scale = np.abs(got - expect), np.abs(expect).max()
        assert np.quantile(diff, 0.999) <= TRAJ_BULK[name] * scale, name
        assert diff.max() <= TRAJ_MAX[name] * scale, (name, diff.max() / scale)


# ---------------------------------------------------------------------------
# launchers and checkpoints
# ---------------------------------------------------------------------------

def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_train_cli_runs_rwkv_on_cpu(tmp_path):
    out = _run(["repro_torch.launch.train", "--arch", ARCH, "--reduced", "--device", "cpu",
                "--method", "async_sam", "--steps", "6", "--batch", "4", "--seq", "32",
                "--save-every", "3", "--ckpt-dir", str(tmp_path / "run"), "--log-every", "1"])
    assert "done: 6 steps, 0 restarts" in out
    losses = [float(x) for x in re.findall(r"^step +\d+ +\{'loss': '([0-9.]+)'", out, re.M)]
    assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    lines = out.strip().splitlines()
    assert json.loads(lines[-2].removeprefix("kernel launches: ")) == {
        "rwkv6_scan_fwd": 0, "rwkv6_scan_bwd": 0, "sq_norm": 0, "sam_perturb": 0,
        "fused_axpy": 0, "fused_dot_norms": 0, "adamw_epilogue": 0, "sgd_epilogue": 0}
    assert json.loads(lines[-1])["arch"] == "rwkv6-7b-reduced"


def test_serve_cli_runs_rwkv_on_cpu():
    out = _run(["repro_torch.launch.serve", "--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "12", "--max-new", "4"], timeout=120)
    assert "prefill: 2x12 tok" in out and "decode : 3 steps" in out
    assert "rwkv6_scan_fwd kernel launches: 0" in out


def test_checkpoints_cross_between_the_packages(reduced, tmp_path):
    """An rwkv6 training state written by either package restores in the
    other, bit for bit (the paths and crc32s of tests/test_torch_checkpoint.py,
    on the rwkv6 tree)."""
    jcfg, cfg, jparams, sd = reduced
    ex = FusedExecutor(build_model(cfg).loss_fn, MethodConfig(name="async_sam", rho=0.05),
                       optim.make_optimizer("adamw", 1e-3))
    state = ex.init_state(_model(cfg, sd), seed=1)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=4, seq_len=16, seed=0,
                                             ascent_fraction=0.25, prefetch=0), device="cpu")
    state = Engine(ex, pipe).fit(state, 2).final_state
    parts = ("params", "opt_state", "method_state")
    like = {k: getattr(state, k) for k in parts}
    CheckpointManager(tmp_path / "port").save(2, state)
    # the reference restores the port's checkpoint, its params the port's values
    jex = JFusedExecutor(jax_build_model(jcfg).loss_fn, JMethodConfig(name="async_sam"),
                         joptim.make_optimizer("adamw", 1e-3), mesh=None, fused_update=True,
                         resident=True)
    jportable = jbuckets.to_portable(jex.init_state(jparams, jax.random.PRNGKey(1)))
    jrestored, _ = JCheckpointManager(tmp_path / "port").restore(
        jax.eval_shape(lambda: {k: getattr(jportable, k) for k in parts}))
    port_params = params_from_jax(jax.tree.map(np.asarray, jrestored["params"]))
    assert sorted(port_params) == sorted(sd)
    for name, t in state.params.to_tree().items():
        assert torch.equal(port_params[name], t), name
    # ... writes it back, and the port restores that bit for bit
    JCheckpointManager(tmp_path / "ref").save(2, jrestored)
    restored, _ = CheckpointManager(tmp_path / "ref").restore(like)
    expect = buckets.to_portable(like)
    for part in parts:
        a, b = _tensors(restored[part]), _tensors(expect[part])
        assert len(a) == len(b) > 0, part
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), part


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []
