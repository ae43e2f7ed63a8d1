"""The port's Hopper kernels on the card: each kernel against its plain
version, and the model's kernel path against its plain path.

Every test here needs an NVIDIA GPU and skips without one. Run them on the
card with
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
This file imports torch only (no jax), so it runs where JAX is not installed.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, sq, sk, h, kv, hd, hd_v, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd_v))]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,hd_v,dtype,causal,window,tensor_cores", [
    (2, 256, 256, 4, 4, 64, 64, torch.bfloat16, True, None, True),
    (2, 256, 256, 8, 2, 64, 64, torch.bfloat16, True, None, True),      # GQA
    (1, 128, 128, 8, 1, 128, 128, torch.bfloat16, True, None, True),    # MQA
    (2, 256, 256, 4, 4, 64, 64, torch.bfloat16, True, 64, True),        # window
    (2, 256, 256, 4, 4, 64, 64, torch.bfloat16, False, None, True),     # non-causal
    (1, 1000, 1000, 4, 4, 128, 128, torch.bfloat16, True, None, True),  # ragged
    (3, 37, 37, 4, 2, 64, 64, torch.bfloat16, True, None, True),        # short ragged
    (2, 40, 300, 4, 4, 64, 64, torch.bfloat16, False, None, True),      # Sq != Sk
    (2, 128, 128, 4, 4, 48, 32, torch.bfloat16, True, None, True),      # hd_v != hd
    (1, 64, 64, 2, 2, 256, 256, torch.bfloat16, True, None, True),      # widest head
    (2, 130, 130, 4, 2, 40, 40, torch.bfloat16, True, 50, False),       # hd % 16 != 0
    (2, 256, 256, 4, 2, 64, 64, torch.float32, True, None, False),      # fp32
    (2, 100, 100, 4, 4, 128, 128, torch.float32, True, 16, False),      # fp32 ragged window
])
def test_flash_kernel_matches_plain(dev, b, sq, sk, h, kv, hd, hd_v, dtype, causal, window,
                                    tensor_cores):
    q, k, v = _qkv(dev, b, sq, sk, h, kv, hd, hd_v, dtype)
    assert fa.uses_tensor_cores(q, k, v) == tensor_cores
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.shape == (b, sq, h, hd_v) and out.dtype == dtype
    expect = ref.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])


@pytest.mark.parametrize("offset,tensor_cores", [(0, True), (1, False)])
def test_flash_kernel_reads_strided_inputs(dev, offset, tensor_cores):
    """q/k/v as slices of one fused projection: strided, last dim contiguous;
    an odd element offset breaks 16-byte row alignment (CUDA-core path)."""
    b, s, h, hd = 2, 96, 4, 64
    qkv = torch.randn((b, s, 3, h, hd + offset), device=dev, dtype=torch.bfloat16)
    q, k, v = qkv[..., offset:].unbind(dim=2)
    assert not q.is_contiguous()
    assert fa.uses_tensor_cores(q, k, v) == tensor_cores
    out = fa.flash_attention(q, k, v)
    expect = ref.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[torch.bfloat16])


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 16, 16, 2, 2, 32, 32, torch.float32)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v.cpu())
    with pytest.raises(ValueError):
        fa.flash_attention(*_qkv(dev, 1, 8, 8, 2, 2, 288, 32, torch.float32))
    with pytest.raises(ValueError):
        fa.flash_attention(*_qkv(dev, 1, 8, 8, 3, 2, 32, 32, torch.float32))


def test_model_kernel_path_matches_plain_path(dev):
    cfg = dataclasses.replace(get_config("olmo-1b", reduced=True), compute_dtype="bfloat16")
    bundle = build_model(cfg)
    model = bundle.init(seed=0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), device=dev)
    with torch.inference_mode():
        before = fa.launches
        got, _ = bundle.forward(model, {"tokens": tokens})
        assert fa.launches == before + cfg.n_layers
        ops.set_default_impl("plain")
        try:
            expect, _ = bundle.forward(model, {"tokens": tokens})
        finally:
            ops.set_default_impl(None)
        assert fa.launches == before + cfg.n_layers
    scale = float(expect.float().abs().max())
    assert float((got.float() - expect.float()).abs().max()) <= 2e-2 * scale


def test_prefill_decode_matches_forward_on_card(dev):
    cfg = get_config("olmo-1b", reduced=True)                 # fp32 compute
    bundle = build_model(cfg)
    model = bundle.init(seed=0, device=dev)
    S, n_dec = 40, 4
    tokens = torch.randint(0, cfg.vocab_size, (2, S + n_dec), device=dev)
    with torch.inference_mode():
        full, _ = bundle.forward(model, {"tokens": tokens})
        logits, cache = bundle.prefill(model, {"tokens": tokens[:, :S]}, pad_to=S + n_dec)
        errs = [float((logits[:, -1] - full[:, S - 1]).abs().max())]
        for t in range(S, S + n_dec):
            logits, cache = bundle.decode(model, cache, {"tokens": tokens[:, t:t + 1]})
            errs.append(float((logits[:, 0] - full[:, t]).abs().max()))
    assert cache["pos"] == S + n_dec
    assert max(errs) / float(full.abs().max()) < 3e-3, errs
