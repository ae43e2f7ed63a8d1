"""Port parity for the hybrid family (zamba2-1.2b, reduced): the Mamba2 SSD
scan's plain versions and their gradient, the autograd Function around the
kernels, the model (forward, prefill + decode, its shared attention block
and per-invocation LoRA), its buckets and weights, a Form A AsyncSAM AdamW
trajectory, the launchers and checkpoints, each against the JAX package on
the same inputs and the same (converted) weights.

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
from repro.kernels.mamba2_scan import mamba2_chunked
from repro.models import build_model as jax_build_model
from repro.utils import buckets as jbuckets
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import Engine, FusedExecutor
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ops, ref
from repro_torch.models import analytic_param_count, build_model, synth_batch, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import buckets

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "zamba2-1.2b"


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
        assert analytic_param_count(cfg) == 1_177_813_888


# ---------------------------------------------------------------------------
# the SSD scan: plain versions against the oracles and the Pallas kernel
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, h, p, g, n, seed=0):
    """The reference tests' distributions, drawn with numpy: x ~ 0.5 N(0, 1),
    dt = softplus(N(0, 1)), a = -exp(linspace(-1, 1, H)), b, c ~ 0.3 N(0, 1),
    d = 0.5."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(np.linspace(-1.0, 1.0, h)).astype(np.float32)
    bb = rng.standard_normal((b, s, g, n)).astype(np.float32) * 0.3
    cc = rng.standard_normal((b, s, g, n)).astype(np.float32) * 0.3
    d = np.full((h,), 0.5, np.float32)
    return x, dt, a, bb, cc, d


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (S, chunk, G, init_state): S a multiple of the chunk and not, one group and
# two, with and without an initial state; fp32 throughout, within the
# reference's own kernel-vs-sequential limit of 2e-4 (tests/test_kernels.py)
SCAN_CASES = [(64, 16, 1, False), (64, 16, 2, False), (64, 16, 2, True),
              (60, 16, 1, False), (60, 16, 2, True)]


@pytest.mark.parametrize("s,chunk,g,init", SCAN_CASES)
def test_plain_scans_match_oracles_and_pallas_interpret(s, chunk, g, init):
    ins = _ssd_inputs(2, s, 4, 16, g, 16)
    s0 = (np.random.default_rng(1).standard_normal((2, 4, 16, 16)).astype(np.float32)
          if init else None)
    y, state = ref.mamba2_chunked_plain(*_t(*ins), chunk=chunk, init_state=_t(s0)[0])
    y_s, state_s = ref.mamba2_scan_plain(*_t(*ins), init_state=_t(s0)[0])
    jins = [jnp.asarray(a) for a in ins]
    js0 = None if s0 is None else jnp.asarray(s0)
    expect = [jax.jit(jref.mamba2_scan_ref)(*jins, js0),
              jax.jit(lambda *a_: jref.mamba2_chunked_jnp(*a_, chunk=chunk, init_state=js0))(
                  *jins),
              mamba2_chunked(*jins, chunk=chunk, init_state=js0, interpret=True)]
    assert y.dtype == torch.float32 and state.shape == (2, 4, 16, 16)
    for got_y, got_s in ((y, state), (y_s, state_s)):
        for expect_y, expect_s in expect:
            np.testing.assert_allclose(_np(got_y), _np(expect_y), rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(_np(got_s), _np(expect_s), rtol=2e-4, atol=2e-4)


def test_plain_scan_state_continuation():
    """Two halves, the second from the first's state, give the whole scan
    (tests/test_kernels.py:246-262), and the oracle's values."""
    x, dt, a, b, c, d = _t(*_ssd_inputs(1, 64, 2, 8, 1, 8, seed=2))
    y_full, s_full = ref.mamba2_chunked_plain(x, dt, a, b, c, d, chunk=16)
    y1, s1 = ref.mamba2_chunked_plain(x[:, :32], dt[:, :32], a, b[:, :32], c[:, :32], d,
                                      chunk=16)
    y2, s2 = ref.mamba2_chunked_plain(x[:, 32:], dt[:, 32:], a, b[:, 32:], c[:, 32:], d,
                                      chunk=16, init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s2, s_full, rtol=1e-4, atol=1e-4)
    half = [jnp.asarray(t[:, 32:].numpy()) for t in (x, dt)]
    j1 = jref.mamba2_scan_ref(*(jnp.asarray(t[:, :32].numpy()) for t in (x, dt)),
                              jnp.asarray(a.numpy()),
                              *(jnp.asarray(t[:, :32].numpy()) for t in (b, c)),
                              jnp.asarray(d.numpy()))
    j2 = jref.mamba2_scan_ref(*half, jnp.asarray(a.numpy()),
                              *(jnp.asarray(t[:, 32:].numpy()) for t in (b, c)),
                              jnp.asarray(d.numpy()), init_state=j1[1])
    np.testing.assert_allclose(_np(y2), _np(j2[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s2), _np(j2[1]), rtol=1e-4, atol=1e-4)


def test_plain_scan_bf16_inputs_match_oracle():
    """bf16 x/b/c: fp32 math, y rounded once to bf16 (the oracle's
    .astype(x.dtype)); the state stays fp32."""
    x, dt, a, b, c, d = _ssd_inputs(2, 48, 4, 16, 2, 16, seed=3)
    xb, bb, cb = (torch.from_numpy(v).bfloat16() for v in (x, b, c))
    y, state = ref.mamba2_chunked_plain(xb, *_t(dt, a), bb, cb, *_t(d), chunk=16)
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (xb, bb, cb)]
    y_o, s_o = jax.jit(lambda *a_: jref.mamba2_chunked_jnp(*a_, chunk=16))(
        jb[0], jnp.asarray(dt), jnp.asarray(a), jb[1], jb[2], jnp.asarray(d))
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert _rel_max(state, s_o) <= 2e-4
    np.testing.assert_allclose(_np(y), _np(y_o), rtol=2e-2, atol=2e-2)


# (S, init_state, cotangents, dtype, G): every gradient within 2e-4 of its
# own max (fp32: the sums' order, within the reference's kernel limit); bf16
# x/b/c: dx, db, dc round once to bf16. S = 40 is a multiple of the chunk
# (8), S = 37 is not (the sequential fallback on both sides). da is held to
# 1e-3: it sums dla dt over B and S, and in the head whose decay underflows
# dla is what rounding leaves of exact cancellations (the diagonal of
# exp(cum_t - cum_s) enters once with +1 and once with -1), on either side,
# times dt = 20: 2.0e-4 of max|da| with the bf16 inputs.
GRAD_TOL = {"da": 1e-3}
GRAD_CASES = [(40, False, "both", "float32", 1), (40, True, "both", "float32", 2),
              (37, True, "both", "float32", 2), (40, True, "dy", "float32", 1),
              (40, True, "d_state", "float32", 1), (40, True, "both", "bfloat16", 2)]


@pytest.mark.parametrize("s,init,cotangents,dtype,g", GRAD_CASES)
def test_plain_backward_matches_jax_grad(s, init, cotangents, dtype, g):
    b, h, p, n, chunk = 2, 4, 8, 8, 8
    x, dt, a, bb, cc, d = _ssd_inputs(b, s, h, p, g, n, seed=4)
    dt[..., -1] = 20.0                  # a head whose decay exp(dt a) underflows to 0
    a[-1] = -16.0
    rng = np.random.default_rng(5)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if init else None
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy = None if cotangents == "d_state" else dy
    ds = None if cotangents == "dy" else ds
    tdt = getattr(torch, dtype)
    tx, tb, tc = (torch.from_numpy(v).to(tdt) for v in (x, bb, cc))
    got = ref.mamba2_scan_plain_grads(
        tx, *_t(dt, a), tb, tc, *_t(d), _t(s0)[0],
        None if dy is None else torch.from_numpy(dy).to(tdt), _t(ds)[0], chunk=chunk)

    jdt = jnp.dtype(dtype)
    jx, jb, jc = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (tx, tb, tc))
    js0 = jnp.zeros((b, h, p, n), jnp.float32) if s0 is None else jnp.asarray(s0)

    def loss(x_, dt_, a_, b_, c_, d_, s0_):
        y_, st_ = jref.mamba2_chunked_jnp(x_, dt_, a_, b_, c_, d_, chunk=chunk, init_state=s0_)
        out = jnp.float32(0.0)
        if dy is not None:
            out += jnp.sum(y_.astype(jnp.float32)
                           * jnp.asarray(dy).astype(jdt).astype(jnp.float32))
        if ds is not None:
            out += jnp.sum(st_ * jnp.asarray(ds))
        return out

    want = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(
        jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, jnp.asarray(d), js0)
    for name, gr, e in zip(("dx", "ddt", "da", "db", "dc", "dd", "d_init"), got, want):
        assert tuple(gr.shape) == e.shape, name
        assert str(gr.dtype).removeprefix("torch.") == str(e.dtype), name
        assert np.isfinite(_np(gr)).all(), name
        tol = GRAD_TOL.get(name, 2e-4 if (dtype == "float32" or name in ("ddt", "dd", "d_init"))
                           else 2e-2)
        assert _rel_max(gr, e) <= tol, (name, _rel_max(gr, e))


KERNEL_CHUNK = 64                       # the CUDA backward's chunk length


def _chunk_parallel_grads(x, dt, a, b, c, d, s0, dy, ds, T=KERNEL_CHUNK):
    """The CUDA backward's schedule in float64 (numpy arrays in; dy, ds, s0
    may be None): phase A, each chunk's local state S_c = sum_t x_t dt_t
    exp(total - cum_t) B_t^T and local cotangent U_c = sum_t exp(cum_t) dy_t
    C_t^T; phase B, the two carries h_in[c+1] = exp(total_c) h_in[c] + S_c
    and dh_out[c-1] = exp(total_c) dh_out[c] + U_c; phase C, every chunk's
    gradients from its h_in and dh_out alone, dla summed term by term (W_s +
    the dcy of t >= s + the E of t < s + exp(total) sum(dh_out h_in)).
    Returns (dx, ddt, da, db, dc, dd, d_init_state) as numpy arrays."""
    f64 = torch.float64
    x, dt, a, b, c, d = (torch.from_numpy(np.asarray(v)).to(f64) for v in (x, dt, a, b, c, d))
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dy = torch.zeros_like(x) if dy is None else torch.from_numpy(np.asarray(dy)).to(f64)
    nc = -(-s // T)

    def chunks(v):                  # (B, S, H, ...) zero-padded -> (B, H, nc, T, ...)
        v = torch.nn.functional.pad(v, [0, 0] * (v.dim() - 2) + [0, nc * T - s])
        v = v.reshape(bsz, nc, T, *v.shape[2:])
        return v.movedim(3, 1)

    xs, dys, dts = chunks(x), chunks(dy), chunks(dt)
    bs, cs = (chunks(v.repeat_interleave(h // g, dim=2)) for v in (b, c))
    cum = torch.cumsum(dts * a[None, :, None, None], dim=-1)          # (B, H, nc, T)
    total = cum[..., -1]
    ecum, edec = torch.exp(cum), torch.exp(total[..., None] - cum)

    # phase A, then phase B
    s_loc = torch.einsum("bhctp,bhct,bhctn->bhcpn", xs, dts * edec, bs)
    u_loc = torch.einsum("bhctp,bhct,bhctn->bhcpn", dys, ecum, cs)
    h_in, dh_out = torch.empty_like(s_loc), torch.empty_like(u_loc)
    hv = torch.zeros((bsz, h, p, n), dtype=f64) if s0 is None else torch.from_numpy(s0).to(f64)
    for ci in range(nc):
        h_in[:, :, ci] = hv
        hv = torch.exp(total[:, :, ci, None, None]) * hv + s_loc[:, :, ci]
    gv = torch.zeros((bsz, h, p, n), dtype=f64) if ds is None else torch.from_numpy(ds).to(f64)
    for ci in reversed(range(nc)):
        dh_out[:, :, ci] = gv
        gv = torch.exp(total[:, :, ci, None, None]) * gv + u_loc[:, :, ci]

    # phase C: (t, s) on and below the diagonal only, never a decay divided
    tri = torch.tril(torch.ones(T, T, dtype=torch.bool))
    seg = torch.where(tri, cum[..., :, None] - cum[..., None, :], torch.zeros((), dtype=f64))
    lmat = torch.where(tri, torch.exp(seg), torch.zeros((), dtype=f64))
    cb = torch.einsum("bhctn,bhcsn->bhcts", cs, bs)
    kmat = cb * lmat
    qd = torch.einsum("bhctp,bhcsp->bhcts", dys, xs) * lmat * dts[..., None, :]
    rmat = qd * cb
    dxd = (torch.einsum("bhcts,bhctp->bhcsp", kmat, dys)
           + edec[..., None] * torch.einsum("bhcsn,bhcpn->bhcsp", bs, dh_out))
    dcy_term = ecum[..., None] * torch.einsum("bhctp,bhcpn->bhctn", dys, h_in)
    dc_h = torch.einsum("bhcts,bhcsn->bhctn", qd, bs) + dcy_term
    e_term = (edec * dts)[..., None] * torch.einsum("bhcsp,bhcpn->bhcsn", xs, dh_out)
    db_h = torch.einsum("bhcts,bhctn->bhcsn", qd, cs) + e_term
    dcy, ee = (cs * dcy_term).sum(-1), (bs * e_term).sum(-1)
    pref = torch.cumsum(rmat, dim=-1) - rmat                # row t's sum over k < s
    w = (pref * tri).sum(-2)                                 # over the rows t >= s
    after = torch.flip(torch.cumsum(torch.flip(dcy, [-1]), -1), [-1])      # t >= s
    before = torch.cumsum(ee, -1) - ee                                     # t < s
    carry = torch.exp(total) * (dh_out * h_in).sum((-2, -1))
    dla = w + after + before + carry[..., None]
    ddt = dla * a[None, :, None, None] + (dxd * xs).sum(-1)

    def unchunk(v):                 # (B, H, nc, T, ...) -> (B, S, H, ...)
        return v.movedim(1, 3).reshape(bsz, nc * T, h, *v.shape[4:])[:, :s]

    dx = d[None, None, :, None] * dy + unchunk(dts[..., None] * dxd)
    db_, dc_ = (unchunk(v).reshape(bsz, s, g, h // g, n).sum(3) for v in (db_h, dc_h))
    da = (dla * dts).sum((0, 2, 3))
    dd = (dy * x).sum((0, 1, 3))
    return tuple(v.numpy() for v in (dx, unchunk(ddt), da, db_, dc_, dd, gv))


# (S, init_state, cotangents, G) over H = 4: one step, one whole chunk of the
# kernel's 64, one step past it and several chunks with a ragged end; with
# and without an initial state; from dy, from the final state's cotangent and
# from both
DECOMP_CASES = [(1, True, "both", 2), (1, False, "dy", 2), (64, False, "both", 2),
                (64, True, "d_state", 2), (65, True, "both", 2), (65, False, "dy", 1),
                (200, True, "both", 2), (200, False, "d_state", 2), (200, True, "dy", 1)]


@pytest.mark.parametrize("s,init,cotangents,g", DECOMP_CASES)
def test_chunk_parallel_backward_matches_jax_grad(s, init, cotangents, g):
    """The CUDA backward's three phases (local chunk states, the carries,
    per-chunk gradients), rendered in float64 by _chunk_parallel_grads,
    against jax.grad of the oracle `mamba2_chunked_jnp` on the same inputs,
    a head whose decay underflows to 0 included. Limits as for the plain
    backward (GRAD_TOL): the oracle's own fp32 rounding is what they allow
    for, and what it leaves of da's exact cancellations in that head."""
    b, h, p, n = 2, 4, 8, 8
    x, dt, a, bb, cc, d = _ssd_inputs(b, s, h, p, g, n, seed=10)
    dt[..., -1] = 20.0
    a[-1] = -16.0
    rng = np.random.default_rng(11)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if init else None
    dy = None if cotangents == "d_state" else rng.standard_normal((b, s, h, p)).astype(np.float32)
    ds = None if cotangents == "dy" else rng.standard_normal((b, h, p, n)).astype(np.float32)
    got = _chunk_parallel_grads(x, dt, a, bb, cc, d, s0, dy, ds)

    def loss(x_, dt_, a_, b_, c_, d_, s0_):
        y_, st_ = jref.mamba2_chunked_jnp(x_, dt_, a_, b_, c_, d_, chunk=KERNEL_CHUNK,
                                          init_state=s0_)
        out = jnp.float32(0.0)
        if dy is not None:
            out += jnp.sum(y_ * jnp.asarray(dy))
        if ds is not None:
            out += jnp.sum(st_ * jnp.asarray(ds))
        return out

    js0 = jnp.zeros((b, h, p, n), jnp.float32) if s0 is None else jnp.asarray(s0)
    want = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(
        *(jnp.asarray(v) for v in (x, dt, a, bb, cc, d)), js0)
    for name, gr, e in zip(("dx", "ddt", "da", "db", "dc", "dd", "d_init"), got, want):
        e = np.asarray(e)
        assert gr.shape == e.shape, name
        assert np.isfinite(gr).all(), name
        if not e.any():                          # no path from the given cotangent
            assert not gr.any(), name
            continue
        assert _rel_max(gr, e) <= GRAD_TOL.get(name, 2e-4), (name, _rel_max(gr, e))


def _chunk_parallel_forward(x, dt, a, b, c, d, s0, T=KERNEL_CHUNK):
    """The CUDA forward's schedule in float64 (numpy arrays in; s0 may be
    None): phase A, each chunk's local state S_c = sum_t x_t dt_t exp(total -
    cum_t) B_t^T and exp(total); phase B, the carry h_in[c+1] = exp(total_c)
    h_in[c] + S_c, whose last value is the final state; phase C, every
    chunk's y = M (x) + exp(cum) (C h_in^T) + d x from its h_in alone, M =
    tril(C B^T) * exp(cum_t - cum_s) * dt_s formed only on and below the
    diagonal. (With one chunk the kernel runs A and C in one CTA from h_in =
    s0: the same arithmetic.) Returns (y, final state) as numpy arrays."""
    f64 = torch.float64
    x, dt, a, b, c, d = (torch.from_numpy(np.asarray(v)).to(f64) for v in (x, dt, a, b, c, d))
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-s // T)

    def chunks(v):                  # (B, S, H, ...) zero-padded -> (B, H, nc, T, ...)
        v = torch.nn.functional.pad(v, [0, 0] * (v.dim() - 2) + [0, nc * T - s])
        return v.reshape(bsz, nc, T, *v.shape[2:]).movedim(3, 1)

    xs, dts = chunks(x), chunks(dt)
    bs, cs = (chunks(v.repeat_interleave(h // g, dim=2)) for v in (b, c))
    cum = torch.cumsum(dts * a[None, :, None, None], dim=-1)          # (B, H, nc, T)
    total = cum[..., -1]

    # phase A, then phase B
    s_loc = torch.einsum("bhctp,bhct,bhctn->bhcpn", xs, dts * torch.exp(total[..., None] - cum),
                         bs)
    h_in = torch.empty_like(s_loc)
    hv = torch.zeros((bsz, h, p, n), dtype=f64) if s0 is None else torch.from_numpy(s0).to(f64)
    for ci in range(nc):
        h_in[:, :, ci] = hv
        hv = torch.exp(total[:, :, ci, None, None]) * hv + s_loc[:, :, ci]

    # phase C: M on and below the diagonal only, never a decay divided
    tri = torch.tril(torch.ones(T, T, dtype=torch.bool))
    seg = torch.where(tri, cum[..., :, None] - cum[..., None, :], torch.zeros((), dtype=f64))
    mmat = torch.where(tri, torch.einsum("bhctn,bhcsn->bhcts", cs, bs) * torch.exp(seg)
                       * dts[..., None, :], torch.zeros((), dtype=f64))
    y = (torch.einsum("bhcts,bhcsp->bhctp", mmat, xs)
         + torch.exp(cum)[..., None] * torch.einsum("bhctn,bhcpn->bhctp", cs, h_in))
    y = y.movedim(1, 3).reshape(bsz, nc * T, h, p)[:, :s] + d[None, None, :, None] * x
    return y.numpy(), hv.numpy()


# (S, init_state, G) over H = 4: one step (the decode step: one chunk), one
# whole chunk of the kernel's 64, a ragged second chunk and four chunks; with
# and without an initial state; one group and two
FWD_DECOMP_CASES = [(s, init, g) for s in (1, 64, 100, 256) for init in (True, False)
                    for g in (1, 2)]


@pytest.mark.parametrize("s,init,g", FWD_DECOMP_CASES)
def test_chunk_parallel_forward_matches_oracles(s, init, g):
    """The CUDA forward's three phases (local chunk states, the carry, each
    chunk's outputs from its entering state), rendered in float64 by
    _chunk_parallel_forward, a head whose decay underflows to 0 included:
    within 1e-10 of the sequential recurrence in float64 (the port's plain
    scan, `ref.mamba2_scan_plain`, on float64 inputs), which pins the
    algebra; and within the reference's kernel limit of 2e-4 of the JAX
    package's chunked oracle `mamba2_chunked_jnp` and its Pallas kernel in
    interpret mode (which takes neither an initial state nor a ragged S and
    falls back to the oracle for them), whose fp32 rounding is what that
    limit allows for."""
    b, h, p, n = 2, 4, 8, 8
    x, dt, a, bb, cc, d = _ssd_inputs(b, s, h, p, g, n, seed=12)
    dt[..., -1] = 20.0
    a[-1] = -16.0
    s0 = (np.random.default_rng(13).standard_normal((b, h, p, n)).astype(np.float32)
          if init else None)
    y, state = _chunk_parallel_forward(x, dt, a, bb, cc, d, s0)

    y64, state64 = ref.mamba2_scan_plain(*(t.double() for t in _t(x, dt, a, bb, cc, d)),
                                         init_state=None if s0 is None
                                         else torch.from_numpy(s0).double())
    assert _rel_max(y, y64.numpy()) <= 1e-10 and _rel_max(state, state64.numpy()) <= 1e-10
    jins = [jnp.asarray(v) for v in (x, dt, a, bb, cc, d)]
    js0 = None if s0 is None else jnp.asarray(s0)
    expect = [jax.jit(lambda *a_: jref.mamba2_chunked_jnp(*a_, chunk=KERNEL_CHUNK,
                                                           init_state=js0))(*jins),
              mamba2_chunked(*jins, chunk=KERNEL_CHUNK, init_state=js0, interpret=True)]
    for expect_y, expect_s in expect:
        assert np.isfinite(y).all() and np.isfinite(state).all()
        assert _rel_max(y, expect_y) <= 2e-4, _rel_max(y, expect_y)
        assert _rel_max(state, expect_s) <= 2e-4, _rel_max(state, expect_s)


def test_reference_cannot_differentiate_its_pallas_kernel():
    """The reference's fault: jax.grad through `mamba2_chunked` (interpret
    mode, the path its TPU training would take) raises AssertionError on
    jax 0.9.0, so it differentiates only its oracle; the port's backward is
    a kernel of its own, held against jax.grad of the oracle."""
    x, dt, a, b, c, d = (jnp.asarray(v) for v in _ssd_inputs(1, 32, 2, 16, 1, 16, seed=6))
    with pytest.raises(AssertionError):
        jax.grad(lambda x_: mamba2_chunked(x_, dt, a, b, c, d, chunk=16,
                                           interpret=True)[0].sum())(x)


# ---------------------------------------------------------------------------
# the autograd Function, with the plain versions standing in for the kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_kernels(monkeypatch):
    """Route CPU calls through `Mamba2Scan`, its launches replaced by the
    plain versions; returns the calls' arguments."""
    calls = {"fwd": [], "bwd": []}

    def fwd(x, dt, a, b, c, d, init_state):
        calls["fwd"].append(init_state is not None)
        with torch.no_grad():
            return ref.mamba2_chunked_plain(x, dt, a, b, c, d, chunk=8, init_state=init_state)

    def bwd(x, dt, a, b, c, d, init_state, dy, d_state):
        calls["bwd"].append((dy is not None, d_state is not None))
        return ref.mamba2_scan_plain_grads(x, dt, a, b, c, d, init_state, dy, d_state, chunk=8)

    monkeypatch.setattr(m2, "_launch_fwd", fwd)
    monkeypatch.setattr(m2, "_launch_bwd", bwd)
    monkeypatch.setattr(m2, "mamba2_scan",
                        lambda x, dt, a, b, c, d, init_state=None, chunk=128:
                        m2.Mamba2Scan.apply(x, dt, a, b, c, d, init_state))
    return calls


@pytest.mark.parametrize("init", [False, True])
def test_function_gradients_are_the_plain_versions(fake_kernels, init):
    ins = _t(*_ssd_inputs(2, 24, 4, 8, 2, 8, seed=7))
    if init:
        ins.append(torch.from_numpy(np.random.default_rng(8).standard_normal(
            (2, 4, 8, 8)).astype(np.float32)))
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y, state = m2.mamba2_scan(*leaves)
    loss = (y * y.cos()).sum() + (state * state).sum()
    got = torch.autograd.grad(loss, leaves)
    assert fake_kernels == {"fwd": [init], "bwd": [(True, True)]}
    plain = [t.clone().requires_grad_(True) for t in ins]
    y_p, state_p = ref.mamba2_chunked_plain(*plain[:6], chunk=8,
                                            init_state=plain[6] if init else None)
    want = torch.autograd.grad((y_p * y_p.cos()).sum() + (state_p * state_p).sum(), plain)
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-6)


def test_function_passes_a_missing_cotangent_as_none(fake_kernels):
    """Only y reaches the loss: the state's cotangent is None, not a zero
    tensor (the kernel reads none); the init state gets no gradient when
    none was given."""
    leaves = [t.requires_grad_(True) for t in _t(*_ssd_inputs(1, 8, 2, 8, 1, 8, seed=9))]
    y, _ = m2.mamba2_scan(*leaves)
    y.sum().backward()
    assert fake_kernels["bwd"] == [(True, False)]
    assert all(t.grad is not None for t in leaves)


@pytest.fixture(scope="module")
def reduced():
    jcfg, cfg = jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, sd


def _perturbed(jparams):
    """The reduced init with its zero LoRA `b`s given values, so that the
    adapters' path carries signal (the tests hold their gradients too)."""
    rng = np.random.default_rng(11)
    lora = {k: (v if k.endswith("_a") else
                jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.05))
            for k, v in jparams["lora"].items()}
    return {**jparams, "lora": lora}


@pytest.mark.parametrize("remat,forwards", [("none", 1), ("full", 2), ("dots", 2)])
def test_remat_gradients_match_jax_and_rerun_the_scan(reduced, fake_kernels, remat, forwards):
    """Each remat mode gives the reference's gradients; "full" and "dots"
    rerun every mamba block's forward (and its scan launch) in backward, and
    the backward kernel runs once per block."""
    jcfg, cfg, jparams, _ = reduced
    jparams = _perturbed(jparams)
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
    ins = _t(*_ssd_inputs(1, 6, 2, 8, 1, 8, seed=10))
    s0 = torch.zeros((1, 2, 8, 8))
    before = dict(m2.launches)
    y, state = ops.mamba2_mix(*ins, chunk=8)
    y_p, state_p = ref.mamba2_chunked_plain(*ins, chunk=8)
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    torch.testing.assert_close(state, state_p, rtol=0, atol=0)
    y1, state1 = ops.mamba2_decode_step(*(t[:, :1] for t in ins[:2]), ins[2],
                                        *(t[:, :1] for t in ins[3:5]), ins[5], state=s0)
    y1_p, state1_p = ref.mamba2_scan_plain(*(t[:, :1] for t in ins[:2]), ins[2],
                                           *(t[:, :1] for t in ins[3:5]), ins[5], s0)
    torch.testing.assert_close(y1, y1_p, rtol=0, atol=0)
    torch.testing.assert_close(state1, state1_p, rtol=0, atol=0)
    assert m2.launches == before
    with pytest.raises(ValueError):
        ops.mamba2_mix(*ins, impl="pallas")


# ---------------------------------------------------------------------------
# the model: JAX init -> params_from_jax -> port
# ---------------------------------------------------------------------------

def _model(cfg, sd):
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(sd)
    return model


def test_state_dict_names_mirror_jax_leaves(reduced):
    jcfg, cfg, jparams, sd = reduced
    model = _model(cfg, sd)
    names = set(model.state_dict())
    assert names == set(sd)
    n_inv = math.ceil(cfg.n_layers / cfg.hybrid.period)
    assert {"embedding.embed", "embedding.unembed", "final_norm.scale", "blocks.0.ln.scale",
            "blocks.4.mixer.wz", "blocks.2.mixer.dt_bias", "shared.attn.wq",
            "shared.mlp.wg", "shared.ln2.scale", "lora.attn_a", "lora.mlp_b"} <= names
    assert len(names) == 3 + cfg.n_layers * (1 + 13) + 2 + 4 + 3 + 4
    assert tuple(model.lora.attn_a.shape) == jparams["lora"]["attn_a"].shape == (
        n_inv, cfg.d_model, cfg.hybrid.lora_rank)
    assert tuple(model.lora.mlp_b.shape) == jparams["lora"]["mlp_b"].shape


def test_init_draws_the_reference_distributions():
    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg, n_layers=3, d_model=256, d_ff=512, vocab_size=128,
                              n_heads=4, n_kv_heads=4,
                              hybrid=dataclasses.replace(cfg.hybrid, period=2, lora_rank=16))
    model = transformer.init_params(cfg, seed=0, device="cpu").requires_grad_(False)
    m = model.blocks[1].mixer
    n_heads = 2 * 256 // 64
    torch.testing.assert_close(m.a_log, torch.log(torch.linspace(1.0, 16.0, n_heads)))
    torch.testing.assert_close(m.dt_bias, torch.full((n_heads,), math.log(math.expm1(0.01))))
    assert float(m.dt_bias[0]) == pytest.approx(-4.600166, abs=1e-5)    # not 0
    assert bool((m.d_skip == 1.0).all()) and bool((m.gate_norm_scale == 1.0).all())
    assert not m.conv_x_b.any() and not m.conv_bc_b.any()
    assert abs(float(m.conv_x_w.std()) * 2.0 - 1.0) < 0.05             # N(0,1)/sqrt(4)
    d = cfg.d_model
    assert abs(float(m.wz.std()) * d ** 0.5 - 0.88) < 0.05               # truncated N(0,1)
    assert abs(float(m.w_out.std()) * 512 ** 0.5 * 6 ** 0.5 - 0.88) < 0.05   # 1/sqrt(2 L)
    assert abs(float(model.shared.attn.wo.std()) * d ** 0.5 * 6 ** 0.5 - 0.88) < 0.05
    lora = model.lora
    assert lora.attn_a.shape == (2, d, 16) and not lora.attn_b.any() and not lora.mlp_b.any()
    for i in range(2):
        assert abs(float(lora.mlp_a[i].std()) * d ** 0.5 - 0.88) < 0.05
    assert bool((model.blocks[0].ln.scale == 1.0).all())


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
    for part, names in (("layers", ["conv_bc", "conv_x", "ssm"]), ("shared", ["k", "v"])):
        assert sorted(cache[part]) == sorted(j_cache[part]) == names
        for name, t in cache[part].items():
            jt = j_cache[part][name]
            assert tuple(t.shape) == jt.shape and str(t.dtype).removeprefix(
                "torch.") == str(jt.dtype), name
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


def test_zamba2_reduced_forward_prefill_decode_match_jax(reduced):
    """fp32 compute: within 2e-5 of the logits' max (LoRA `b`s nonzero)."""
    jcfg, cfg, jparams, _ = reduced
    jparams = _perturbed(jparams)
    sd = params_from_jax(jax.tree.map(np.asarray, jparams))
    _slice_parity(jcfg, cfg, jparams, _model(cfg, sd), rel_tol=2e-5, check_tokens=True)


def _coarse(sd, bits):
    """The state dict with every fp32 weight rounded to `bits` significant
    bits (bf16 keeps 8): the same model in a lower precision."""
    drop = 24 - bits
    out = {}
    for k, v in sd.items():
        iv = v.float().contiguous().view(torch.int32)
        out[k] = ((iv + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)
    return out


# bf16 compute against the reference's bf16 compute, as a share of the
# logits' max: the two round to bf16 at other places (XLA's and torch's CPU
# kernels), through the reduced model's 5 mamba and 3 shared blocks, each
# about bf16's own error from fp32 (the reference's bf16 logits are 2.7e-2 of
# their max from its fp32 logits here). The largest reading, over the
# forward, prefill, cache and decode, is 2.5e-2; the control, the port with
# its weights at 6 significant bits, reads 1.2e-1 and must fail the limit.
ZAMBA2_BF16_TOL = 4e-2


def test_zamba2_reduced_bf16_compute_matches_jax(reduced):
    """Same (fp32) weights, bf16 compute on both sides: within
    ZAMBA2_BF16_TOL, and the same model at two bits less than bf16's
    precision (its weights rounded) outside it."""
    jcfg, cfg, jparams, sd = reduced
    jcfg16 = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    _slice_parity(jcfg16, cfg16, jparams, _model(cfg, sd), rel_tol=ZAMBA2_BF16_TOL,
                  check_tokens=False)
    j16 = jax.jit(jax_build_model(jcfg16).forward)(jparams, {"tokens": jnp.asarray(tokens)})[0]
    with torch.inference_mode():
        coarse, _ = transformer.forward(_model(cfg, _coarse(sd, 6)),
                                        {"tokens": torch.from_numpy(tokens)}, cfg16)
    assert _rel_max(coarse, j16) > ZAMBA2_BF16_TOL, _rel_max(coarse, j16)


def test_prefill_decode_matches_full_forward(reduced):
    """The port alone: prefill (20 tokens, not a multiple of the chunk) +
    one-token decode steps == one forward."""
    _, cfg, _, sd = reduced
    model = _model(cfg, sd)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 25),
                                                                dtype=np.int32))
    with torch.inference_mode():
        full, _ = transformer.forward(model, {"tokens": tokens}, cfg)
        logits, cache = transformer.prefill(model, {"tokens": tokens[:, :20]}, cfg, pad_to=25)
        errs = [_rel_max(logits[:, -1], full[:, 19])]
        for t in range(20, 25):
            logits, cache = transformer.decode(model, cache, {"tokens": tokens[:, t:t + 1]},
                                               cfg)
            errs.append(_rel_max(logits[:, 0], full[:, t]))
    assert max(errs) <= 2e-5, errs


def test_init_cache_matches_reference_structure():
    cfg, jcfg = get_config(ARCH, reduced=True), jax_get_config(ARCH, reduced=True)
    jc = jax_build_model(jcfg).init_cache(2, 10, pos=3)
    c = transformer.init_cache(cfg, 2, 10, pos=3, device="cpu")
    assert c["pos"] == int(jc["pos"]) == 3
    assert sorted(c) == sorted(jc)
    for part in ("layers", "shared"):
        assert sorted(c[part]) == sorted(jc[part])
        for name, t in c[part].items():
            assert tuple(t.shape) == jc[part][name].shape and not t.any()
            assert str(t.dtype).removeprefix("torch.") == str(jc[part][name].dtype)


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
    (blocks/{ln,mixer}/* stacked on L, then embedding, final_norm, lora and
    shared), bit for bit."""
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
    assert spans[0][0] == ("blocks", "ln", "scale") and ("lora", "attn_a") in [
        k for k, _, _ in spans]
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
    back = params_from_jax(tree)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


# ---------------------------------------------------------------------------
# Form A AsyncSAM AdamW trajectory
# ---------------------------------------------------------------------------

BATCH, SEQ, ASCENT_FRACTION, STEPS = 8, 32, 0.25, 6
# The argument of tests/test_torch_train.py (olmo-1b-reduced, whose limits
# these are): both sides compute in fp32 on the same weights and batches and
# differ in the order of sums; Adam normalizes each update, so a weight
# whose gradient sits at that rounding noise can take its step (about lr)
# the other way, and the moments and the ascent buffer follow it. The scalar
# metrics stay within 1e-4 relative, 99.9% of every buffer within 1e-4 of
# its max and every element within 1e-3; the cosine of nearly orthogonal
# ascent gradients carries their own difference (5e-3 absolute).
TRAJ_LR, TRAJ_RTOL, COS_ATOL = 3e-3, 1e-4, 5e-3
TRAJ_BULK, TRAJ_MAX = 1e-4, 1e-3


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
        assert np.quantile(diff, 0.999) <= TRAJ_BULK * scale, name
        assert diff.max() <= TRAJ_MAX * scale, (name, diff.max() / scale)


# ---------------------------------------------------------------------------
# launchers and checkpoints
# ---------------------------------------------------------------------------

def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_train_cli_runs_zamba2_on_cpu(tmp_path):
    out = _run(["repro_torch.launch.train", "--arch", ARCH, "--reduced", "--device", "cpu",
                "--method", "async_sam", "--steps", "6", "--batch", "4", "--seq", "32",
                "--save-every", "3", "--ckpt-dir", str(tmp_path / "run"), "--log-every", "1"])
    assert "done: 6 steps, 0 restarts" in out
    losses = [float(x) for x in re.findall(r"^step +\d+ +\{'loss': '([0-9.]+)'", out, re.M)]
    assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    lines = out.strip().splitlines()
    assert json.loads(lines[-2].removeprefix("kernel launches: ")) == {
        "flash_attention": 0, "mamba2_scan_fwd": 0, "mamba2_scan_bwd": 0, "sq_norm": 0,
        "sam_perturb": 0, "fused_axpy": 0, "fused_dot_norms": 0, "adamw_epilogue": 0,
        "sgd_epilogue": 0}
    assert json.loads(lines[-1])["arch"] == "zamba2-1.2b-reduced"


def test_serve_cli_runs_zamba2_on_cpu():
    out = _run(["repro_torch.launch.serve", "--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "12", "--max-new", "4"], timeout=120)
    assert "prefill: 2x12 tok" in out and "decode : 3 steps" in out
    assert "mamba2_scan_fwd kernel launches: 0" in out
    assert "flash_attention kernel launches: 0" in out


def test_checkpoints_cross_between_the_packages(reduced, tmp_path):
    """A zamba2 training state written by either package restores in the
    other, bit for bit (the paths and crc32s of tests/test_torch_checkpoint.py,
    on the hybrid tree with its stacked LoRA)."""
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
