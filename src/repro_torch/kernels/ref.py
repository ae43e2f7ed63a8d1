"""Plain PyTorch versions of the attention kernels (counterpart of
`repro.kernels.ref`).

Each function mirrors its jnp oracle line for line: it is the CPU path, the
oracle the Hopper kernels are held against on the card, and is itself held
against the JAX oracle by tests/test_torch_flash_attention.py. Inputs keep the
JAX package's layout: q (B,Sq,H,hd), k/v (B,Sk,K,hd[_v]).
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
