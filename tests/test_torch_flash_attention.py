"""Port parity: the plain PyTorch attention versions against the JAX package's
Pallas kernel (interpret mode) and jnp oracles, on the same numpy inputs.

Tolerances are the reference's own (tests/test_kernels.py): fp32 2e-5, bf16
2e-2. The Hopper kernel itself is held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as fa

_DT = {"float32": (jnp.float32, torch.float32, np.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16)}

# the JAX side runs jitted: one compile per case instead of one per primitive
_pallas = jax.jit(pallas_flash, static_argnames=("causal", "window", "block_q", "block_k",
                                                 "interpret"))
_flash_jnp = jax.jit(jref.flash_attention_jnp, static_argnames=("causal", "window",
                                                                 "kv_block"))
_mha_jnp = jax.jit(jref.mha_reference, static_argnames=("causal", "window", "q_offset",
                                                        "kv_valid_len"))
_decode_jnp = jax.jit(jref.decode_attention_jnp, static_argnames=("window",))


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(shape_q, shape_k, shape_v, dtype: str, seed: int = 0):
    """The same values for both frameworks, rounded to `dtype` once in numpy."""
    rng = np.random.default_rng(seed)
    _, tdt, ndt = _DT[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32).astype(ndt)
            for s in (shape_q, shape_k, shape_v)]
    jx = [jnp.asarray(a) for a in arrs]
    tx = [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs]
    return jx, tx


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# Pallas interpret mode: a subset of tests/test_kernels.py's sweep
@pytest.mark.parametrize("b,s,h,kv,hd,dtype,causal,window", [
    (1, 128, 4, 4, 64, "float32", True, None),       # MHA
    (2, 256, 4, 2, 64, "bfloat16", True, None),      # GQA
    (1, 128, 8, 1, 128, "float32", True, 64),        # MQA, window
    (2, 128, 4, 4, 32, "bfloat16", False, None),     # non-causal
    (1, 128, 4, 4, 64, "bfloat16", True, 64),        # window, bf16
    (2, 256, 4, 2, 64, "float32", False, None),      # GQA non-causal
])
def test_plain_matches_pallas_interpret(b, s, h, kv, hd, dtype, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), dtype)
    expect = _pallas(jq, jk, jv, causal=causal, window=window,
                     block_q=64, block_k=64, interpret=True)
    out = ref.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == _DT[dtype][1] and out.shape == (b, s, h, hd)
    np.testing.assert_allclose(_np(out), _np(expect), **_tol(dtype))


@pytest.mark.parametrize("sq,sk,hd,hd_v,kv_block,causal,window,dtype", [
    (100, 100, 64, 64, 512, True, None, "float32"),   # ragged S: naive fallback in both
    (37, 37, 64, 64, 512, True, 8, "bfloat16"),       # short ragged prompt, window
    (192, 192, 64, 64, 64, True, None, "bfloat16"),   # blocked path, S not a power of 2
    (128, 128, 48, 32, 64, True, None, "float32"),    # hd_v != hd (MLA), blocked
    (40, 96, 48, 32, 512, False, None, "float32"),    # hd_v != hd, Sq != Sk, naive
    (64, 192, 64, 64, 64, True, 16, "float32"),       # Sq != Sk, blocked, window
])
def test_plain_matches_jnp_oracle(sq, sk, hd, hd_v, kv_block, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs((2, sq, 4, hd), (2, sk, 2, hd), (2, sk, 2, hd_v),
                                         dtype, seed=1)
    expect = _flash_jnp(jq, jk, jv, causal=causal, window=window, kv_block=kv_block)
    out = ref.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                    kv_block=kv_block)
    assert out.shape == (2, sq, 4, hd_v)
    np.testing.assert_allclose(_np(out), _np(expect), **_tol(dtype))


@pytest.mark.parametrize("q_offset,kv_valid_len,window", [(0, None, None), (5, 20, None),
                                                          (3, None, 4)])
def test_mha_reference_matches_jnp(q_offset, kv_valid_len, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs((2, 8, 4, 32), (2, 24, 1, 32), (2, 24, 1, 32),
                                         "float32", seed=2)
    kw = dict(causal=True, window=window, q_offset=q_offset, kv_valid_len=kv_valid_len)
    np.testing.assert_allclose(_np(ref.mha_reference(tq, tk, tv, **kw)),
                               _np(_mha_jnp(jq, jk, jv, **kw)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("valid_len,window,dtype", [
    (40, None, "float32"), (40, 16, "float32"), (64, None, "bfloat16"), (1, None, "float32"),
    (40, 16, "bfloat16")])
def test_decode_attention_matches_jnp(valid_len, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs((2, 1, 4, 64), (2, 64, 2, 64), (2, 64, 2, 64),
                                         dtype, seed=3)
    expect = _decode_jnp(jq, jk, jv, jnp.asarray(valid_len), window=window)
    out = ops.decode_attention(tq, tk, tv, valid_len, window=window)
    np.testing.assert_allclose(_np(out), _np(expect), **_tol(dtype))


def test_dispatch_on_cpu_uses_plain_and_counts_no_launch():
    _, (tq, tk, tv) = _inputs((1, 64, 2, 32), (1, 64, 2, 32), (1, 64, 2, 32), "float32")
    before = fa.launches
    expect = ref.flash_attention_plain(tq, tk, tv)
    for impl in (None, "kernel", "plain"):
        torch.testing.assert_close(ops.flash_attention(tq, tk, tv, impl=impl), expect,
                                   rtol=0, atol=0)
    assert fa.launches == before
    with pytest.raises(ValueError):
        ops.flash_attention(tq, tk, tv, impl="pallas")
    with pytest.raises(ValueError):
        ops.set_default_impl("jnp")
    ops.set_default_impl("plain")
    try:
        torch.testing.assert_close(ops.flash_attention(tq, tk, tv), expect, rtol=0, atol=0)
    finally:
        ops.set_default_impl(None)


def test_kernel_checks_reject_cpu_tensors():
    _, (tq, tk, tv) = _inputs((1, 8, 2, 32), (1, 8, 2, 32), (1, 8, 2, 32), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fa._check(tq, tk, tv, None)


def test_kernel_module_imports_without_nvcc(monkeypatch, tmp_path):
    """Importing the wrapper (done above, here where there is no nvcc) builds
    nothing; asking for nvcc where there is none raises."""
    assert fa._lib is None
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.nvcc()


# The kernel's path is a plain function of dtype, head dims, strides and base
# alignment, so it is pinned here where the kernel cannot run.
@pytest.mark.parametrize("shape,dtype,offset,path", [
    # (B, Sq, Sk, H, K, hd, hd_v); offset: elements into wider rows
    ((8, 1024, 1024, 16, 16, 128, 128), torch.bfloat16, 0, "wgmma"),  # olmo-1b prefill, batch
    ((2, 1024, 1024, 16, 16, 128, 128), torch.bfloat16, 0, "wgmma"),  # olmo-1b ascent slice
    ((8, 1024, 1024, 32, 32, 64, 64), torch.bfloat16, 0, "wgmma"),    # zamba2 shared block
    ((2, 1024, 1024, 32, 32, 64, 64), torch.bfloat16, 0, "wgmma"),    # zamba2 ascent slice
    ((4, 32, 32, 4, 4, 16, 16), torch.bfloat16, 0, "wgmma"),          # reduced width
    ((2, 256, 256, 16, 2, 128, 128), torch.bfloat16, 0, "wgmma"),     # GQA
    ((2, 512, 512, 16, 16, 192, 128), torch.bfloat16, 0, "wgmma"),    # MLA
    ((1, 64, 64, 2, 2, 256, 256), torch.bfloat16, 0, "wgmma"),        # widest head
    ((2, 256, 256, 4, 2, 64, 64), torch.float32, 0, "cuda_cores"),
    ((2, 256, 256, 4, 2, 40, 40), torch.bfloat16, 0, "cuda_cores"),   # hd % 16 != 0
    ((2, 128, 128, 4, 4, 48, 40), torch.bfloat16, 0, "cuda_cores"),   # hd_v % 16 != 0
    ((2, 256, 256, 4, 4, 128, 128), torch.bfloat16, 1, "cuda_cores"),  # unaligned view
])
def test_kernel_path_by_inputs(shape, dtype, offset, path):
    b, sq, sk, h, kv, hd, hd_v = shape
    q, k, v = (torch.empty((*s[:-1], s[-1] + offset), dtype=dtype)[..., offset:]
               for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd_v)))
    assert fa.kernel_path(q, k, v) == path
    assert fa.uses_tensor_cores(q, k, v) == (path == "wgmma")


def test_kernel_path_of_broadcast_and_strided_views():
    """A broadcast k (stride 0) cannot be read by TMA; a slice of a fused qkv
    projection (strided, 16-byte aligned rows) can."""
    q = torch.empty((2, 64, 4, 64), dtype=torch.bfloat16)
    k = torch.empty((2, 64, 1, 64), dtype=torch.bfloat16).expand(2, 64, 4, 64)
    assert fa.kernel_path(q, k, k) == "cuda_cores"
    qkv = torch.empty((2, 64, 3, 4, 64), dtype=torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous() and fa.kernel_path(q, k, v) == "wgmma"


@pytest.mark.parametrize("arch,compute,path", [
    ("olmo-1b", "bfloat16", "wgmma"), ("zamba2-1.2b", "bfloat16", "wgmma"),
    ("olmo-1b", "float32", "cuda_cores"), ("zamba2-1.2b", "float32", "cuda_cores")])
def test_model_attention_calls_take_their_kernel_path(monkeypatch, arch, compute, path):
    """Every attention call of a reduced model's serving (no grad) and
    training (grad) forward would take `path` on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype=compute)
    bundle = build_model(cfg)
    model = bundle.init(seed=0, device=torch.device("cpu"))
    seen, plain = [], fa.flash_attention

    def spy(q, k, v, **kw):
        seen.append(fa.kernel_path(q, k, v))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        bundle.forward(model, {"tokens": tokens})
    n_serving = len(seen)
    bundle.forward(model, {"tokens": tokens})[0].float().sum().backward()
    assert n_serving >= 1 and len(seen) >= 2 * n_serving
    assert set(seen) == {path}
