"""Plain PyTorch versions of the kernels (counterpart of `repro.kernels.ref`).

Each function mirrors its jnp oracle line for line: it is the CPU path, the
oracle the Hopper kernels are held against on the card, and is itself held
against the JAX oracle by tests/test_torch_flash_attention.py (attention),
tests/test_torch_fused_update.py (the flat-buffer weight-space functions),
tests/test_torch_rwkv.py (the rwkv6 wkv scan and its gradient) and
tests/test_torch_zamba2.py (the Mamba2 SSD scan and its gradient).
Attention inputs keep the JAX package's layout: q (B,Sq,H,hd), k/v
(B,Sk,K,hd[_v]). The flat-buffer functions take 1-D buckets, compute in fp32
and return `y`'s or `w`'s dtype, as the oracles do.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

_NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,K,hd) -> (B,S,H,hd) by repeating kv heads for GQA."""
    n_kv = k.shape[-2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=-2)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0,
                  kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """Naive materialized attention (mirror of `ref.mha_reference`).

    `q_offset`: absolute position of q[0]. `kv_valid_len`: number of valid
    cache entries.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    dev = q.device
    kx = _gqa_expand(k, h).float()
    vx = _gqa_expand(v, h).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx)
    scores = scores / math.sqrt(hd)
    qpos = torch.arange(sq, device=dev) + q_offset
    kpos = torch.arange(sk, device=dev)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    if kv_valid_len is not None:
        mask &= kpos[None, :] < kv_valid_len
    scores = torch.where(mask[None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vx)
    return out.to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          kv_block: int = 512) -> torch.Tensor:
    """Online-softmax attention over kv blocks (mirror of
    `ref.flash_attention_jnp`; the jnp `lax.scan` becomes a Python loop).

    Falls back to `mha_reference` when `sk % kv_block != 0`, as the oracle
    does. `hd_v` may differ from `hd` (MLA).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sk % kv_block != 0:
        return mha_reference(q, k, v, causal=causal, window=window)
    n_blocks = sk // kv_block
    n_kv = k.shape[2]
    g = h // n_kv
    hd_v = v.shape[-1]
    dev = q.device
    qg = q.reshape(b, sq, n_kv, g, hd).float() / math.sqrt(hd)
    qpos = torch.arange(sq, device=dev)

    m = torch.full((b, n_kv, g, sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n_kv, g, sq, hd_v), dtype=torch.float32, device=dev)
    for blk in range(n_blocks):
        lo = blk * kv_block
        kblk = k[:, lo:lo + kv_block].float()
        vblk = v[:, lo:lo + kv_block].float()
        kpos = lo + torch.arange(kv_block, device=dev)
        # grouped GQA: contract per kv head without materializing the repeat
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kblk)
        mask = torch.ones((sq, kv_block), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        s = torch.where(mask[None, None, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vblk)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]                 # (B,K,G,Sq,hdv)
    out = out.reshape(b, h, sq, hd_v).transpose(1, 2)         # -> (B,Sq,H,hdv)
    return out.to(q.dtype)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: Union[int, torch.Tensor], *,
                           window: Optional[int] = None) -> torch.Tensor:
    """Attention of new positions over a KV cache (mirror of
    `ref.decode_attention_jnp`).

    q (B,Sq,H,hd); k/v (B,S_max,K,hd). Cache entries at or beyond `valid_len`
    are masked; `window` keeps only the last `window` valid entries.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    n_kv = k.shape[2]
    g = h // n_kv
    qg = q.reshape(b, sq, n_kv, g, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s / math.sqrt(hd)
    kpos = torch.arange(sk, device=q.device)
    mask = kpos[None, :] < valid_len                          # (1, Sk)
    if window is not None:
        mask &= kpos[None, :] > valid_len - 1 - window
    s = torch.where(mask[None, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# RWKV6 (Finch): sequential wkv scan
# ---------------------------------------------------------------------------

def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor, init_state: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 recurrence with data-dependent decay (mirror of
    `ref.rwkv6_scan_ref`; its `lax.scan` becomes a Python loop).

    r,k,w (B,S,H,K); v (B,S,H,V); u (H,K) bonus; w is the *log* decay (<0):
      y_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t
      S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T
    Math in fp32; returns y (B,S,H,V) in r's dtype and the final state
    (B,H,K,V) in fp32.
    """
    B, S, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv))
        s = torch.exp(wf[:, t])[..., None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def rwkv6_scan_plain_grads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           w: torch.Tensor, u: torch.Tensor,
                           init_state: Optional[torch.Tensor], dy: Optional[torch.Tensor],
                           d_state: Optional[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du, d_init_state) of `rwkv6_scan_plain` for the
    cotangents dy of y and d_state of the final state (None: zero), by
    autograd: what `jax.grad` of the oracle gives, each in its input's dtype
    (d_init_state fp32: the gradient at a zero state when `init_state` is
    None)."""
    B, _, H, K = r.shape
    s0 = (torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32, device=r.device)
          if init_state is None else init_state)
    inputs = [t.detach().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    with torch.enable_grad():
        y, s = rwkv6_scan_plain(*inputs)
        outs = [o for o, d in ((y, dy), (s, d_state)) if d is not None]
        grads = [d for d in (dy, d_state) if d is not None]
        if not outs:
            return tuple(torch.zeros_like(t) for t in inputs)
        got = torch.autograd.grad(outs, inputs, grads, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for g, t in zip(got, inputs))


# ---------------------------------------------------------------------------
# Mamba2 (SSD): sequential scan and its chunked form
# ---------------------------------------------------------------------------

def _mamba2_heads(b: torch.Tensor, c: torch.Tensor, n_heads: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,S,G,N) gates -> (B,S,H,N) in the math dtype: group g serves heads
    g*H/G .. (g+1)*H/G - 1 (the reference's jnp.repeat)."""
    rep = n_heads // b.shape[2]
    f = _mamba2_math(b)
    return (torch.repeat_interleave(b, rep, dim=2).to(f),
            torch.repeat_interleave(c, rep, dim=2).to(f))


def _mamba2_math(x: torch.Tensor) -> torch.dtype:
    """fp32, the reference's math, for fp32 and bf16 inputs; float64 for
    float64 inputs (a witness of the fp32 versions' rounding)."""
    return torch.promote_types(x.dtype, torch.float32)


def mamba2_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, d: torch.Tensor,
                      init_state: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence (mirror of `ref.mamba2_scan_ref`; its
    `lax.scan` becomes a Python loop).

    x (B,S,H,P); dt (B,S,H) the softplus'd timestep; a (H,) the negative
    decay rate; b, c (B,S,G,N), G groups broadcast over the heads; d (H,)
    the skip:
      h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t^T;   y_t = h_t c_t + d x_t
    Math in fp32 (float64 for float64 inputs, `_mamba2_math`); returns y
    (B,S,H,P) in x's dtype and the final state (B,H,P,N) in the math dtype.
    """
    B, S, H, P = x.shape
    bb, cc = _mamba2_heads(b, c, H)
    f = _mamba2_math(x)
    xf, dtf = x.to(f), dt.to(f)
    decay = torch.exp(dtf * a.to(f)[None, None, :])
    h = (torch.zeros((B, H, P, bb.shape[-1]), dtype=f, device=x.device)
         if init_state is None else init_state.to(f))
    ys = []
    for t in range(S):
        h = h * decay[:, t, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None], bb[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, cc[:, t]))
    y = torch.stack(ys, dim=1) + xf * d.to(f)[None, None, :, None]
    return y.to(x.dtype), h


def mamba2_chunked_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, d: torch.Tensor, chunk: int = 128,
                         init_state: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: dense within a chunk, the state carried across chunks
    (mirror of `ref.mamba2_chunked_jnp`, the Pallas kernel's blocking).
    Falls back to `mamba2_scan_plain` when S % chunk != 0, as the oracle
    does; the same function either way."""
    B, S, H, P = x.shape
    if S % chunk != 0:
        return mamba2_scan_plain(x, dt, a, b, c, d, init_state)
    N = b.shape[3]
    nc = S // chunk
    bb, cc = (t.reshape(B, nc, chunk, H, N) for t in _mamba2_heads(b, c, H))
    f = _mamba2_math(x)
    dtf = dt.to(f)
    xf = (x.to(f) * dtf[..., None]).reshape(B, nc, chunk, H, P)      # dt-scaled input
    la = dtf.reshape(B, nc, chunk, H) * a.to(f)[None, None, None, :]
    cum = torch.cumsum(la, dim=2)                                     # (B,nc,T,H)
    total = cum[:, :, -1]                                             # (B,nc,H)

    # intra-chunk: y[t] = sum_{s<=t} exp(cum[t]-cum[s]) (C_t . B_s) x_s
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]               # (B,nc,T,T,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    gmat = torch.exp(torch.where(tri[None, None, :, :, None], seg, -math.inf))
    cb = torch.einsum("bntHm,bnsHm->bntsH", cc, bb)
    y_intra = torch.einsum("bntsH,bntsH,bnsHp->bntHp", cb, gmat, xf)

    # chunk states, then the carry across chunks
    sdecay = torch.exp(total[:, :, None, :] - cum)                    # (B,nc,T,H)
    chunk_state = torch.einsum("bnsHm,bnsH,bnsHp->bnHpm", bb, sdecay, xf)
    h = (torch.zeros((B, H, P, N), dtype=f, device=x.device)
         if init_state is None else init_state.to(f))
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(total[:, n])[..., None, None] + chunk_state[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)                             # (B,nc,H,P,N) entering

    y_inter = torch.einsum("bntHm,bntH,bnHpm->bntHp", cc, torch.exp(cum), h_prevs)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + x.to(f) * d.to(f)[None, None, :, None]
    return y.to(x.dtype), h


def mamba2_scan_plain_grads(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                            init_state: Optional[torch.Tensor], dy: Optional[torch.Tensor],
                            d_state: Optional[torch.Tensor], chunk: int = 128
                            ) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, da, db, dc, dd, d_init_state) of `mamba2_chunked_plain`
    for the cotangents dy of y and d_state of the final state (None: zero),
    by autograd: what `jax.grad` of the oracle gives, each in its input's
    dtype (d_init_state in the math dtype: the gradient at a zero state
    when `init_state` is None)."""
    B, _, H, P = x.shape
    s0 = (torch.zeros((B, H, P, b.shape[-1]), dtype=_mamba2_math(x), device=x.device)
          if init_state is None else init_state)
    inputs = [t.detach().requires_grad_(True) for t in (x, dt, a, b, c, d, s0)]
    with torch.enable_grad():
        y, s = mamba2_chunked_plain(*inputs[:6], chunk=chunk, init_state=inputs[6])
        outs = [o for o, g in ((y, dy), (s, d_state)) if g is not None]
        grads = [g for g in (dy, d_state) if g is not None]
        if not outs:
            return tuple(torch.zeros_like(t) for t in inputs)
        got = torch.autograd.grad(outs, inputs, grads, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for g, t in zip(got, inputs))


# ---------------------------------------------------------------------------
# Flat-buffer weight-space functions (the SAM perturbation and the fused
# optimizer epilogue)
# ---------------------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def sam_perturb_scale(rho, sq_norm, device: torch.device) -> torch.Tensor:
    """rho / (sqrt(sq_norm) + 1e-12) as an fp32 device scalar: the scale the
    reference's `sam_perturb` computes before its kernel. A host rho is
    filled in on the device (no copy from the host, which would wait for the
    stream), then divided, as the reference divides."""
    sq = _f32(sq_norm).to(device)
    rho = (_f32(rho).to(device) if isinstance(rho, torch.Tensor)
           else torch.full_like(sq, rho))
    return rho / (torch.sqrt(sq) + 1e-12)


def sam_perturb_flat_plain(w: torch.Tensor, g: torch.Tensor, rho, sq_norm) -> torch.Tensor:
    """w + rho * g / sqrt(sq_norm) in fp32, w's dtype out (mirror of
    `ref.sam_perturb_flat_jnp` with the Pallas kernel's cast to w's dtype)."""
    scale = sam_perturb_scale(rho, sq_norm, w.device)
    return (w.float() + scale * g.float()).to(w.dtype)


def sq_norm_plain(g: torch.Tensor) -> torch.Tensor:
    """Sum of squares in fp32 (mirror of `ref.sq_norm_jnp`)."""
    return torch.sum(torch.square(g.float()))


def axpy_flat_plain(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + alpha * x (fp32 accumulation, y's dtype out; mirror of
    `ref.axpy_flat_jnp`)."""
    return (y.float() + _f32(alpha).to(y.device) * x.float()).to(y.dtype)


def dot_norms_flat_plain(a: torch.Tensor, b: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(<a,b>, ||a||^2, ||b||^2) in fp32 (mirror of `ref.dot_norms_flat_jnp`)."""
    a32 = a.float()
    b32 = b.float()
    return torch.sum(a32 * b32), torch.sum(a32 * a32), torch.sum(b32 * b32)


def _kept(keep, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """`new` where the guard's verdict `keep` is nonzero, else `old` (in
    `new`'s dtype: the same bits as the kernels' skip, which writes nothing)."""
    if keep is None:
        return new
    return torch.where(_f32(keep).to(new.device) != 0, new, old.to(new.dtype))


def sgd_epilogue_flat_plain(w: torch.Tensor, g: torch.Tensor, m: Optional[torch.Tensor],
                            clip_scale, lr, *, momentum: float = 0.0, nesterov: bool = False,
                            weight_decay: float = 0.0, keep=None
                            ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(w', m' or None) of one clip-decay-momentum-lr step (mirror of
    `ref.sgd_epilogue_flat_jnp`); w' keeps w's dtype, m' is fp32. Weight
    decay enters u before the momentum, as `add_decayed_weights` precedes
    `trace` in the reference's sgd chain. `keep` 0 (the numerics guard's
    skip) gives back w and m as they were."""
    dev = w.device
    w32 = w.float()
    u = g.float() * _f32(clip_scale).to(dev)
    if weight_decay:
        u = u + weight_decay * w32
    lr = _f32(lr).to(dev)
    if not momentum:
        return _kept(keep, (w32 - lr * u).to(w.dtype), w), None
    m_new = momentum * m.float() + u
    d = momentum * m_new + u if nesterov else m_new
    return _kept(keep, (w32 - lr * d).to(w.dtype), w), _kept(keep, m_new, m)


def adamw_epilogue_flat_plain(w: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                              nu: torch.Tensor, clip_scale, lr, c1, c2, *,
                              b1: float = 0.9, b2: float = 0.999,
                              eps: float = 1e-8, weight_decay: float = 0.0, keep=None
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w', mu', nu') of one clip-Adam-decay-lr step (mirror of
    `ref.adamw_epilogue_flat_jnp`); w' keeps w's dtype, mu'/nu' are fp32.
    `keep` 0 (the numerics guard's skip) gives back w, mu and nu as they
    were."""
    dev = w.device
    w32 = w.float()
    g32 = g.float() * _f32(clip_scale).to(dev)
    mu_new = b1 * mu.float() + (1.0 - b1) * g32
    nu_new = b2 * nu.float() + (1.0 - b2) * torch.square(g32)
    upd = ((mu_new / _f32(c1).to(dev))
           / (torch.sqrt(nu_new / _f32(c2).to(dev)) + eps))
    if weight_decay:
        upd = upd + weight_decay * w32
    w_new = (w32 - _f32(lr).to(dev) * upd).to(w.dtype)
    return _kept(keep, w_new, w), _kept(keep, mu_new, mu), _kept(keep, nu_new, nu)


def delta_amax_flat_plain(p: torch.Tensor, s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """max |p - s + e| in fp32, the int8 JOB-delta scale probe (mirror of
    `ref.delta_amax_flat_jnp`); a NaN anywhere gives NaN, as jnp.max does."""
    d = p.float() - s.float() + e.float()
    return torch.amax(torch.abs(d))


def delta_encode_i8_flat_plain(p: torch.Tensor, s: torch.Tensor, e: torch.Tensor, scale
                               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q int8, s' fp32, e' fp32) of one int8 delta encode (mirror of
    `ref.delta_encode_i8_flat_jnp`):

        d = (p - s) + e;  q = clip(round(d / scale), -127, 127)
        s' = s + f32(q) * scale;  e' = d - f32(q) * scale

    torch.round rounds half to even, as jnp.round does. A NaN d gives q = 0,
    as the oracle's cast to int8 gives (so s' = s there, the server's numpy
    apply of that q); torch's own cast of NaN to int8 is undefined."""
    scale = _f32(scale).to(p.device)
    d = p.float() - s.float() + e.float()
    r = torch.clamp(torch.round(d / scale), -127, 127)
    q = torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)
    recon = q.float() * scale
    return q, s.float() + recon, d - recon
