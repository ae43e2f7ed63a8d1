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


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,hd_v,dtype,causal,window,path", [
    (2, 256, 256, 4, 4, 64, 64, torch.bfloat16, True, None, "wgmma"),
    (2, 256, 256, 8, 2, 64, 64, torch.bfloat16, True, None, "wgmma"),        # GQA
    (2, 256, 256, 16, 2, 128, 128, torch.bfloat16, True, None, "wgmma"),     # GQA, H/K = 8
    (1, 128, 128, 8, 1, 128, 128, torch.bfloat16, True, None, "wgmma"),      # MQA
    (2, 256, 256, 4, 4, 64, 64, torch.bfloat16, True, 64, "wgmma"),          # window
    (2, 256, 256, 4, 4, 64, 64, torch.bfloat16, False, None, "wgmma"),       # non-causal
    (1, 1000, 1000, 4, 4, 128, 128, torch.bfloat16, True, None, "wgmma"),    # ragged
    (3, 37, 37, 4, 2, 64, 64, torch.bfloat16, True, None, "wgmma"),          # short ragged
    (2, 200, 200, 4, 4, 128, 128, torch.bfloat16, True, None, "wgmma"),      # rows past Sq
    (2, 40, 300, 4, 4, 64, 64, torch.bfloat16, False, None, "wgmma"),        # Sq != Sk
    (2, 130, 330, 4, 2, 128, 128, torch.bfloat16, False, 100, "wgmma"),      # Sk % 128, window
    (2, 128, 128, 4, 4, 48, 32, torch.bfloat16, True, None, "wgmma"),        # hd_v != hd
    (2, 256, 256, 4, 4, 128, 64, torch.bfloat16, True, None, "wgmma"),       # hd_v < hd
    (2, 300, 300, 4, 4, 192, 128, torch.bfloat16, True, None, "wgmma"),      # MLA
    (1, 64, 64, 2, 2, 256, 256, torch.bfloat16, True, None, "wgmma"),        # widest head
    (2, 300, 300, 8, 2, 256, 256, torch.bfloat16, True, None, "wgmma"),      # 256, ragged
    (2, 300, 300, 4, 4, 256, 128, torch.bfloat16, True, None, "wgmma"),      # 64-key tiles
    (2, 130, 130, 4, 2, 40, 40, torch.bfloat16, True, 50, "cuda_cores"),     # hd % 16 != 0
    (2, 256, 256, 4, 2, 64, 64, torch.float32, True, None, "cuda_cores"),    # fp32
    (2, 100, 100, 4, 4, 128, 128, torch.float32, True, 16, "cuda_cores"),    # fp32 ragged window
])
def test_flash_kernel_matches_plain(dev, b, sq, sk, h, kv, hd, hd_v, dtype, causal, window,
                                    path):
    q, k, v = _qkv(dev, b, sq, sk, h, kv, hd, hd_v, dtype)
    assert fa.kernel_path(q, k, v) == path
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.shape == (b, sq, h, hd_v) and out.dtype == dtype
    expect = ref.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,q_off,dtype,window,path", [
    (2, 64, 256, 8, 2, 128, 0, torch.bfloat16, None, "wgmma"),
    (2, 64, 256, 8, 2, 128, 64, torch.bfloat16, None, "wgmma"),
    (2, 64, 256, 8, 2, 128, 192, torch.bfloat16, None, "wgmma"),       # the last block
    (2, 200, 1000, 4, 4, 64, 600, torch.bfloat16, None, "wgmma"),      # ragged, mid-tile
    (2, 128, 512, 4, 4, 64, 300, torch.bfloat16, 100, "wgmma"),        # window
    (1, 256, 4096, 40, 8, 128, 3840, torch.bfloat16, None, "wgmma"),   # qwen2.5-32b rank 15
    (2, 64, 256, 4, 2, 64, 96, torch.float32, None, "cuda_cores"),
    (2, 50, 300, 4, 2, 64, 170, torch.float32, 40, "cuda_cores"),
])
def test_flash_kernel_with_a_query_offset(dev, b, sq, sk, h, kv, hd, q_off, dtype, window,
                                          path):
    """A rank's block of queries (query row i at position q_off + i) against
    the whole sequence's keys, as the "fsdp_sp" layout calls the kernel:
    the plain version with the same offset, and the whole causal call's
    rows [q_off, q_off + sq)."""
    q, k, v = _qkv(dev, b, sk, sk, h, kv, hd, hd, dtype)
    qb = q[:, q_off:q_off + sq].contiguous()
    assert fa.kernel_path(qb, k, v) == path
    before = fa.launches
    out = fa.flash_attention(qb, k, v, causal=True, window=window, q_offset=q_off)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    expect = ref.flash_attention_plain(qb, k, v, causal=True, window=window, q_offset=q_off)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])
    whole = fa.flash_attention(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), whole[:, q_off:q_off + sq].float(), **TOL[dtype])


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64), (torch.bfloat16, 128),
                                      (torch.float32, 64)])
def test_flash_kernel_rows_that_see_no_key_are_zeros(dev, dtype, hd):
    """With a window and Sq > Sk, query rows past Sk + window - 1 see no key:
    the kernel writes them as zeros, as the Pallas kernel does (the plain
    version follows the jnp oracle there: the mean of the values)."""
    b, sq, sk, h, window = 2, 300, 100, 4, 16
    q, k, v = _qkv(dev, b, sq, sk, h, h, hd, hd, dtype)
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    empty = torch.arange(sq, device=dev) >= sk + window - 1
    assert int(empty.sum()) == sq - (sk + window - 1)
    assert bool((out[:, empty] == 0).all())
    expect = ref.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out[:, ~empty].float(), expect[:, ~empty].float(), **TOL[dtype])


@pytest.mark.parametrize("offset,path", [(0, "wgmma"), (1, "cuda_cores")])
def test_flash_kernel_reads_strided_inputs(dev, offset, path):
    """q/k/v as slices of one fused projection: strided, last dim contiguous;
    an odd element offset breaks 16-byte row alignment (CUDA-core path)."""
    b, s, h, hd = 2, 96, 4, 64
    qkv = torch.randn((b, s, 3, h, hd + offset), device=dev, dtype=torch.bfloat16)
    q, k, v = qkv[..., offset:].unbind(dim=2)
    assert not q.is_contiguous()
    assert fa.kernel_path(q, k, v) == path
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


# ---------------------------------------------------------------------------
# the flat-buffer kernels of the training step
# ---------------------------------------------------------------------------

FLAT_SIZES = [1, 1000, 65536, 3 * 65536 + 17]


def _flat(dev, n, dtype, seed, scale=1.0, offset=0, positive=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.empty(n + offset, device=dev)
    t.uniform_(0, scale, generator=g) if positive else t.normal_(0, scale, generator=g)
    return t.to(dtype)[offset:]


def _rel(got, expect) -> float:
    return float((got.float() - expect.float()).abs().max()) / max(
        float(expect.float().abs().max()), 1e-30)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", FLAT_SIZES)
def test_reduction_kernels_match_plain(dev, n, dtype, offset):
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import sam_perturb as sp
    a = _flat(dev, n, torch.float32, 0, offset=offset)
    b = _flat(dev, n, dtype, 1, offset=offset)
    before = sp.launches["sq_norm"]
    got = sp.sq_norm(b)
    assert sp.launches["sq_norm"] == before + 1 and got.dtype == torch.float32
    assert _rel(got, ref.sq_norm_plain(b)) <= 2e-5
    assert float(sp.sq_norm(b)) == float(got)                       # no atomics: same bits
    before = fu.launches["fused_dot_norms"]
    got3 = fu.fused_dot_norms(a, b)
    assert fu.launches["fused_dot_norms"] == before + 1
    scale = float((got3[1] * got3[2]).sqrt())
    for g, e in zip(got3, ref.dot_norms_flat_plain(a, b)):
        assert abs(float(g) - float(e)) <= 2e-5 * max(abs(float(e)), scale)


# sq_norm sweeps 4,096-element tiles, a CTA each: sizes at a tile's edges,
# several tiles and a ragged end, olmo-1b-reduced's bucket (98,304), and
# more tiles than the card holds CTAs at once (1,100)
SQ_TILE = 4096
SQ_NORM_SIZES = [1, SQ_TILE - 1, SQ_TILE, SQ_TILE + 1, 5 * SQ_TILE + 3, 98_304,
                 1100 * SQ_TILE + 5]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", SQ_NORM_SIZES)
def test_sq_norm_sweep_matches_plain_and_reruns_bitwise(dev, n, dtype, offset):
    """sq_norm at its sweep's edges, fp32 and bf16, aligned and from a view
    starting at element 1 (the element-by-element path): within 2e-5 of its
    plain version, and a rerun gives the same bits."""
    from repro_torch.kernels import sam_perturb as sp
    assert sp.sq_norm_tile() == SQ_TILE
    g = _flat(dev, n, dtype, 2, offset=offset)
    before = sp.launches["sq_norm"]
    got = sp.sq_norm(g)
    assert sp.launches["sq_norm"] == before + 1
    assert got.shape == () and got.dtype == torch.float32
    assert _rel(got, ref.sq_norm_plain(g)) <= 2e-5
    assert torch.equal(sp.sq_norm(g), got)


# fused_axpy sweeps 1,024-element tiles, four elements a thread: sizes at a
# tile's edges and with a ragged vector at the end
SWEEP_SIZES = [1023, 1024, 1025, 4 * 1024 + 3]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", SWEEP_SIZES)
def test_fused_axpy_sweep_edges_bitwise(dev, n, dtype, offset):
    """fused_axpy at the sweep's tile edges, aligned and not (offset 1
    leaves x and y off their 16-byte alignment: the element-by-element
    path), fp32 x and fp32 or bf16 y: bitwise its plain version."""
    from repro_torch.kernels import fused_update as fu
    x = _flat(dev, n, torch.float32, 6, 1e-3, offset)
    y = _flat(dev, n, dtype, 7, 2e-2, offset)
    alpha = torch.tensor(0.37, device=dev)
    out = torch.empty_like(y)
    before = fu.launches["fused_axpy"]
    assert fu.fused_axpy(alpha, x, y, out=out) is out
    assert fu.launches["fused_axpy"] == before + 1
    torch.testing.assert_close(out, ref.axpy_flat_plain(alpha, x, y), rtol=0, atol=0)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", FLAT_SIZES)
def test_elementwise_kernels_match_plain_bitwise(dev, n, dtype, offset):
    """axpy and adamw round where the plain version does (no FMA contraction,
    IEEE division and sqrt), so on the card they agree bit for bit."""
    from repro_torch.kernels import fused_update as fu
    x = _flat(dev, n, torch.float32, 2, 1e-3, offset)
    y = _flat(dev, n, dtype, 3, 2e-2, offset)
    alpha = torch.tensor(-3.7, device=dev)
    out = torch.empty_like(y)
    before = fu.launches["fused_axpy"]
    assert fu.fused_axpy(alpha, x, y, out=out) is out
    assert fu.launches["fused_axpy"] == before + 1
    torch.testing.assert_close(out, ref.axpy_flat_plain(alpha, x, y), rtol=0, atol=0)
    mu = _flat(dev, n, torch.float32, 4, 1e-4, offset)
    nu = _flat(dev, n, torch.float32, 5, 1e-7, offset, positive=True)
    scal = [torch.tensor(v, device=dev) for v in (0.7, 1e-3, 0.19, 0.001999)]
    for wd in (0.0, 0.1):
        w, m, v = y.clone(), mu.clone(), nu.clone()
        fu.adamw_epilogue(w, x, m, v, *scal, weight_decay=wd)
        for got, e in zip((w, m, v), ref.adamw_epilogue_flat_plain(y, x, mu, nu, *scal,
                                                                   weight_decay=wd)):
            torch.testing.assert_close(got, e, rtol=0, atol=0)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", FLAT_SIZES)
def test_sgd_and_perturb_kernels_match_plain_bitwise(dev, n, dtype, offset):
    """sgd_epilogue (each body) and sam_perturb round where the plain version
    does, so on the card they agree bit for bit; both write in place, and a
    rerun gives the same bits."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import sam_perturb as sp
    g = _flat(dev, n, torch.float32, 6, 1e-3, offset)
    w0 = _flat(dev, n, dtype, 7, 2e-2, offset)
    m0 = _flat(dev, n, torch.float32, 8, 1e-3, offset)
    clip, lr = torch.tensor(0.7, device=dev), torch.tensor(0.1, device=dev)
    for mom, nest, wd in ((0.9, False, 0.0), (0.9, True, 1e-4), (0.9, False, 1e-4),
                          (0.0, False, 5e-4), (0.0, False, 0.0)):
        runs = []
        for _ in range(2):
            w, m = w0.clone(), m0.clone()
            ptrs = (w.data_ptr(), m.data_ptr())
            before = fu.launches["sgd_epilogue"]
            wk, mk = fu.sgd_epilogue(w, g, m if mom else None, clip, lr, momentum=mom,
                                     nesterov=nest, weight_decay=wd)
            assert fu.launches["sgd_epilogue"] == before + 1
            assert wk is w and (mk is m if mom else mk is None)
            assert (w.data_ptr(), m.data_ptr()) == ptrs
            runs.append((w, m))
        ew, em = ref.sgd_epilogue_flat_plain(w0, g, m0, clip, lr, momentum=mom, nesterov=nest,
                                             weight_decay=wd)
        for w, m in runs:
            torch.testing.assert_close(w, ew, rtol=0, atol=0)
            torch.testing.assert_close(m, em if mom else m0, rtol=0, atol=0)
    sq = ref.sq_norm_plain(g)
    out = torch.empty_like(w0)
    before = sp.launches["sam_perturb"]
    assert sp.sam_perturb(w0, g, 0.05, sq, out=out) is out
    assert sp.launches["sam_perturb"] == before + 1 and out.dtype == dtype
    torch.testing.assert_close(out, ref.sam_perturb_flat_plain(w0, g, 0.05, sq), rtol=0, atol=0)
    w = w0.clone()
    sp.sam_perturb(w, g, torch.tensor(0.05, device=dev), sq, out=w)     # in place
    torch.testing.assert_close(w, out, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", FLAT_SIZES)
def test_perturb_matches_axpy_at_the_same_scale_bitwise(dev, n, dtype):
    """sam_perturb(w, g, rho, sq) is fused_axpy(rho / (sqrt(sq) + 1e-12), g,
    w): the same bits, with out aliasing w."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import sam_perturb as sp
    g = _flat(dev, n, torch.float32, 9, 1e-3)
    w0 = _flat(dev, n, dtype, 10, 2e-2)
    sq = ref.sq_norm_plain(g)
    scale = ref.sam_perturb_scale(0.05, sq, dev)
    w, y = w0.clone(), w0.clone()
    assert sp.sam_perturb(w, g, 0.05, sq, out=w) is w
    assert fu.fused_axpy(scale, g, y, out=y) is y
    torch.testing.assert_close(w, y, rtol=0, atol=0)
    assert not torch.equal(w, w0)


def _at(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of `t` `offset` elements into a fresh buffer (offset 1 breaks
    16-byte alignment, so the kernel takes its element-by-element path)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)[offset:]
    return buf.copy_(t)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", FLAT_SIZES)
def test_delta_kernels_match_plain_bitwise(dev, n, dtype, offset):
    """delta_amax and delta_encode_i8 equal their plain versions bit for bit
    (amax, q, s', e'): the client's shadow must be the server's; s and e are
    written in place, and a rerun gives the same bits."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.service.delta import _pow2_scale
    p = _flat(dev, n, dtype, 9, 1.0, offset)
    s = _at(p.float() + _flat(dev, n, torch.float32, 10, 1e-2), offset)
    e = _flat(dev, n, torch.float32, 11, 1e-3, offset)
    before = fu.launches["delta_amax"]
    amax = fu.delta_amax(p, s, e)
    assert fu.launches["delta_amax"] == before + 1 and amax.dtype == torch.float32
    assert float(amax) == float(ref.delta_amax_flat_plain(p, s, e))
    scale = float(_pow2_scale(float(amax)))
    expect = ref.delta_encode_i8_flat_plain(p, s, e, scale)
    for _ in range(2):
        sk, ek = _at(s, offset), _at(e, offset)
        before = fu.launches["delta_encode_i8"]
        q, s2, e2 = fu.delta_encode_i8(p, sk, ek, scale)
        assert fu.launches["delta_encode_i8"] == before + 1
        assert s2 is sk and e2 is ek and q.dtype == torch.int8
        for got, want in zip((q, sk, ek), expect):
            assert torch.equal(got, want)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_delta_kernels_carry_nonfinite_params_as_plain(dev, bad):
    """A NaN in p reaches the amax (the per-chunk partials and the final max
    keep it); q, s' and e' equal the plain version's, NaN for NaN."""
    from repro_torch.kernels import fused_update as fu
    p = _flat(dev, 3 * 65536 + 17, torch.float32, 12)
    p[[5, 70000, 3 * 65536 + 3]] = bad
    s = p.nan_to_num(0.0, 0.0, 0.0) + _flat(dev, p.numel(), torch.float32, 13, 1e-2)
    e = torch.zeros_like(s)
    amax, want = fu.delta_amax(p, s, e), ref.delta_amax_flat_plain(p, s, e)
    assert torch.equal(amax, want) or (bool(amax.isnan()) and bool(want.isnan()))
    q, sk, ek = fu.delta_encode_i8(p, s.clone(), e.clone(), 1.0)
    for got, exp in zip((q, sk, ek), ref.delta_encode_i8_flat_plain(p, s, e, 1.0)):
        assert torch.equal(got.nan_to_num(0.5), exp.nan_to_num(0.5))
        assert torch.equal(got.isnan(), exp.isnan())


def test_remote_loopback_runs_the_delta_kernels(dev):
    """A short loopback remote run on the card (the MLP of service.testing,
    its server spawned on the card): int8 deltas through both kernels, each
    launched once per delta job, and no encode failure."""
    import numpy as np

    from repro_torch.core import MethodConfig
    from repro_torch.engine import Engine, RemoteExecutor
    from repro_torch.kernels import fused_update as fu
    from repro_torch.optim import sgd
    from repro_torch.runtime import ExecutorConfig
    from repro_torch.service.testing import MLP_LOSS_SPEC, mlp_init, mlp_loss

    rng = np.random.default_rng(0)

    def batch():
        x, ax = (torch.from_numpy(rng.standard_normal((b, 8)).astype(np.float32)).to(dev)
                 for b in (32, 16))
        y, ay = (torch.from_numpy(rng.integers(0, 4, b).astype(np.int32)).to(dev)
                 for b in (32, 16))
        return {"x": x, "y": y, "ascent": {"x": ax, "y": ay}}

    ex = RemoteExecutor(mlp_loss, MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5),
                        sgd(0.1, momentum=0.9),
                        exec_cfg=ExecutorConfig(lockstep=True, serve_ascent=True,
                                                loss_spec=MLP_LOSS_SPEC, descent_device=dev,
                                                job_compress="int8"))
    with ex:
        state = ex.init_state(mlp_init(0, device=dev), seed=1)
        before = dict(fu.launches)
        report = Engine(ex, [batch() for _ in range(5)]).fit(state, 5)
        enc = ex.client.job_encoder
    assert [m["tau"] for m in report.metrics_history] == [0.0] + [1.0] * 4
    assert (enc.snapshot_jobs, enc.delta_jobs, enc.encode_failures) == (1, 4, 0)
    for k in ("delta_amax", "delta_encode_i8"):
        assert fu.launches[k] - before[k] == enc.delta_jobs


def test_flat_kernels_reject_what_they_do_not_take(dev):
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import sam_perturb as sp
    x = torch.ones(10, device=dev)
    with pytest.raises(TypeError):
        sp.sq_norm(x.half())
    with pytest.raises(ValueError):
        sp.sq_norm(x.view(2, 5))
    with pytest.raises(ValueError):
        fu.fused_axpy(1.0, x, torch.ones(9, device=dev))
    with pytest.raises(ValueError):
        fu.fused_dot_norms(x, x.cpu())
    with pytest.raises(TypeError):
        fu.adamw_epilogue(x, x, x.bfloat16(), x, 1.0, 1e-3, 0.1, 0.1)
    with pytest.raises(ValueError):
        fu.fused_axpy(1.0, x[::2], x[::2])
    with pytest.raises(TypeError):
        fu.sgd_epilogue(x, x, x.bfloat16(), 1.0, 1e-3, momentum=0.9)
    with pytest.raises(ValueError):
        fu.sgd_epilogue(x, x, None, 1.0, 1e-3, momentum=0.9)
    with pytest.raises(ValueError):
        sp.sam_perturb(x, x.cpu(), 0.05, 1.0)


def test_reduced_training_kernel_path_matches_plain_path(dev):
    """olmo-1b-reduced (fp32 compute) trains 4 AsyncSAM steps on the card
    through the kernels, once per step each, and agrees with the plain path."""
    from repro_torch.core import MethodConfig
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.engine import Engine, FusedExecutor
    from repro_torch.launch.train import kernel_launches
    from repro_torch.optim import cosine_schedule, make_optimizer

    cfg = get_config("olmo-1b", reduced=True)
    runs = {}
    for impl in ("plain", "kernel"):
        ops.set_default_impl(impl)
        try:
            bundle = build_model(cfg)
            ex = FusedExecutor(bundle.loss_fn, MethodConfig(rho=0.05),
                               make_optimizer("adamw", cosine_schedule(1e-3, 4)))
            state = ex.init_state(bundle.init(seed=0, device=dev), seed=1)
            pipe = TokenPipeline(cfg, PipelineConfig(global_batch=8, seq_len=64, seed=0,
                                                     ascent_fraction=0.25, prefetch=0),
                                 device=dev)
            before = kernel_launches()
            report = Engine(ex, pipe).fit(state, 4)
            after = kernel_launches()
        finally:
            ops.set_default_impl(None)
        runs[impl] = (report, {k: after[k] - before[k] for k in after})
    (rp, lp), (rk, lk) = runs["plain"], runs["kernel"]
    assert lp == dict.fromkeys(lp, 0)
    assert lk == {"flash_attention": 4 * 2 * cfg.n_layers, "sq_norm": 4, "sam_perturb": 0,
                  "fused_axpy": 4, "fused_dot_norms": 4, "adamw_epilogue": 4,
                  "sgd_epilogue": 0}
    for mp, mk in zip(rp.metrics_history, rk.metrics_history):
        for k in ("loss", "ascent_norm", "grad_norm"):
            assert mk[k] == pytest.approx(mp[k], rel=1e-4), k
    # fp32 compute: the paths differ in the order of sums only; a weight whose
    # gradient sits at that noise may take Adam's ~lr step the other way, so
    # the bulk is held to 1e-4 of max|w| and every weight to 2 sum(lr)
    wp, wk = rp.final_state.params.buffers[0], rk.final_state.params.buffers[0]
    diff = (wk - wp).abs()
    assert float(torch.quantile(diff[:2**24].float(), 0.999)) <= 1e-4 * float(wp.abs().max())
    assert float(diff.max()) <= 2 * 4 * 1e-3


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", FLAT_SIZES)
def test_epilogue_keep_flag_skips_bitwise(dev, n, dtype, offset):
    """The numerics guard's flag: at keep 0 adamw_epilogue and sgd_epilogue
    launch, return at once and leave every buffer as it was bit for bit (NaN
    gradients included); at keep 1 they compute what they compute without
    it, bit for bit."""
    from repro_torch.kernels import fused_update as fu
    g = _flat(dev, n, torch.float32, 9, 1e-3, offset)
    g[::5] = float("nan")
    w0 = _flat(dev, n, dtype, 10, 2e-2, offset)
    mu0 = _flat(dev, n, torch.float32, 11, 1e-4, offset)
    nu0 = _flat(dev, n, torch.float32, 12, 1e-7, offset, positive=True)
    scal = [torch.tensor(v, device=dev) for v in (0.7, 1e-3, 0.19, 0.001999)]
    zero, one = torch.zeros((), device=dev), torch.ones((), device=dev)
    runs = {}
    for keep in (zero, one, None):
        w, mu, nu = w0.clone(), mu0.clone(), nu0.clone()
        before = fu.launches["adamw_epilogue"]
        fu.adamw_epilogue(w, g, mu, nu, *scal, weight_decay=0.1, keep=keep)
        assert fu.launches["adamw_epilogue"] == before + 1
        runs[None if keep is None else float(keep)] = (w, mu, nu)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(runs[0.0], (w0, mu0, nu0)))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(runs[1.0], runs[None]))
    for mom in (0.9, 0.0):
        out = {}
        for keep in (zero, one, None):
            w, m = w0.clone(), mu0.clone()
            fu.sgd_epilogue(w, g, m if mom else None, scal[0], scal[1], momentum=mom,
                            weight_decay=1e-4, keep=keep)
            out[None if keep is None else float(keep)] = (w, m)
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(out[0.0], (w0, mu0)))
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(out[1.0], out[None]))


def test_guarded_reduced_training_skips_on_the_card(dev):
    """olmo-1b-reduced AsyncSAM with guard_update under GuardedExecutor, a NaN
    loss at step 2: update_skipped there only, the weights and moments as
    before it, adamw_epilogue launched every step."""
    from repro_torch.core import MethodConfig
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.engine import Engine, FusedExecutor, GuardedExecutor
    from repro_torch.kernels import fused_update as fu
    from repro_torch.optim import cosine_schedule, make_optimizer

    cfg = get_config("olmo-1b", reduced=True)
    bundle = build_model(cfg)
    poison = {"on": False}

    def loss(params, batch, gen):
        value, aux = bundle.loss_fn(params, batch, gen)
        return (value * float("nan") if poison["on"] else value), aux

    ex = FusedExecutor(loss, MethodConfig(rho=0.05, guard_update=True),
                       make_optimizer("adamw", cosine_schedule(1e-3, 5)))
    g = GuardedExecutor(ex)
    state = g.init_state(bundle.init(seed=0, device=dev), seed=1)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=8, seq_len=64, seed=0,
                                             ascent_fraction=0.25, prefetch=0), device=dev)
    it, skipped = iter(pipe), []
    for i in range(5):
        poison["on"] = i == 2
        before = [t.clone() for t in state.params.buffers + state.opt_state[0].mu.buffers]
        n = fu.launches["adamw_epilogue"]
        state, m = g.step(state, next(it))
        assert fu.launches["adamw_epilogue"] == n + 1
        skipped.append(float(m["update_skipped"]))
        if i == 2:
            after = state.params.buffers + state.opt_state[0].mu.buffers
            assert all(torch.equal(a, b) for a, b in zip(after, before))
            assert float(m["nonfinite_count"]) == sum(t.numel() for t in state.params.buffers)
        assert torch.isfinite(state.method_state.ascent_norm)
    assert skipped == [0.0, 0.0, 1.0, 0.0, 0.0]


def _sgd_trainer(dev, method="async_sam"):
    from repro_torch.core import MethodConfig
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.engine import FusedExecutor
    from repro_torch.optim import cosine_schedule, sgd

    cfg = get_config("olmo-1b", reduced=True)
    bundle = build_model(cfg)
    ex = FusedExecutor(bundle.loss_fn, MethodConfig(name=method, rho=0.05),
                       sgd(cosine_schedule(0.05, 3), momentum=0.9))
    model = bundle.init(seed=0, device=dev)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=8, seq_len=64, seed=0,
                                             ascent_fraction=0.25, prefetch=0), device=dev)
    return cfg, bundle, model, ex, ex.init_state(model, seed=1), pipe


def test_reduced_sgd_training_launches_the_sgd_path(dev):
    """SGD-momentum AsyncSAM launches sgd_epilogue once a step and no
    adamw_epilogue; SAM perturbs through sq_norm + sam_perturb."""
    from repro_torch.engine import Engine
    from repro_torch.launch.train import kernel_launches

    for method, per_step in (("async_sam", {"sq_norm": 1, "fused_axpy": 1,
                                            "fused_dot_norms": 1, "sgd_epilogue": 1}),
                             ("sam", {"sq_norm": 2, "sam_perturb": 1, "sgd_epilogue": 1})):
        cfg, _, _, ex, state, pipe = _sgd_trainer(dev, method)
        before = kernel_launches()
        report = Engine(ex, pipe).fit(state, 3)
        after = kernel_launches()
        got = {k: after[k] - before[k] for k in after}
        want = {k: 3 * per_step.get(k, 0) for k in got}
        fwd = 1 if cfg.remat == "none" else 2          # the block reruns in backward
        want["flash_attention"] = 3 * 2 * fwd * cfg.n_layers    # 2 gradient passes a step
        assert got == want, (method, got)
        assert all(torch.isfinite(torch.tensor(list(m.values()))).all()
                   for m in report.metrics_history)


def test_restart_restores_into_the_live_buffers_bitwise(dev, tmp_path):
    """A failure before step 2 of 3 costs one restart; the final state equals
    the uninterrupted run's bit for bit and the model still views it."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import CheckpointCallback, Engine
    from repro_torch.runtime import InjectedFailure, ResilienceConfig

    _, _, _, ex, state, pipe = _sgd_trainer(dev)
    clean = Engine(ex, pipe).fit(state, 3).final_state
    _, bundle, model, ex, state, pipe = _sgd_trainer(dev)
    live = (state.params.buffers[0], state.opt_state[0].momentum.buffers[0])
    fired = []

    def inject(step):
        if step == 2 and not fired:
            fired.append(step)
            raise InjectedFailure("node lost")

    report = Engine(ex, pipe, [CheckpointCallback(CheckpointManager(tmp_path),
                                                  ResilienceConfig(save_every=1))]).fit(
        state, 3, failure_injector=inject)
    final = report.final_state
    assert report.restarts == 1
    assert final.params.buffers[0] is live[0] and final.opt_state[0].momentum.buffers[0] is live[1]
    for a, b in ((final.params, clean.params), (final.opt_state[0].momentum,
                                                 clean.opt_state[0].momentum),
                 (final.method_state.ascent_grad, clean.method_state.ascent_grad)):
        assert torch.equal(a.buffers[0], b.buffers[0])
    lo = live[0].data_ptr()
    assert all(lo <= p.data_ptr() < lo + live[0].numel() * 4 for p in model.parameters())
    batch = pipe.peek()
    with torch.no_grad():
        torch.testing.assert_close(bundle.loss_fn(model, batch)[0],
                                   bundle.loss_fn(final.params.to_tree(), batch)[0],
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the rwkv6 wkv scan and its backward
# ---------------------------------------------------------------------------

def _wkv_inputs(dev, b, s, h, dk, dv, dtype, init, seed=0):
    """r, k, v in `dtype`; the log decay w = -exp(N(0, 0.5) - 2) and u in
    fp32, as the reference's kernel tests draw them; plus a strongly
    decaying channel (exp(w) underflows to 0) in every head; init_state
    fp32 or None."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape, scale=0.5):
        return torch.randn(shape, generator=g, device=dev) * scale

    r, k = n(b, s, h, dk).to(dtype), n(b, s, h, dk).to(dtype)
    v = n(b, s, h, dv).to(dtype)
    w = -torch.exp(n(b, s, h, dk) - 2.0)
    w[..., 0] = -200.0
    u = n(h, dk, scale=0.1)
    s0 = n(b, h, dk, dv) if init else None
    return r, k, v, w, u, s0


def _rel_max(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


# (B, S, H, K, V, dtype, init_state): the model's head (K = V = 64) in bf16,
# a decode step (S = 1 from a state), ragged S, the reduced config's K = V =
# 16 in fp32, K != V, widths that are not 16, 32 or 64, and K = V = 32 (the
# backward's 128-thread layout) at S = 1 and at one step past a staged chunk;
# then S shorter than the forward's staged chunk (16 steps) and S two chunks
# and 5 steps, at K = V = 64
WKV_CASES = [
    (2, 64, 4, 64, 64, torch.bfloat16, False),
    (3, 1, 4, 64, 64, torch.bfloat16, True),
    (1, 1000, 2, 64, 64, torch.bfloat16, True),
    (2, 100, 3, 16, 16, torch.float32, True),
    (2, 77, 2, 32, 48, torch.float32, True),
    (2, 40, 2, 8, 24, torch.float32, False),
    (2, 1, 4, 32, 32, torch.bfloat16, True),
    (2, 33, 4, 32, 32, torch.bfloat16, True),
    (2, 33, 3, 32, 32, torch.float32, False),
    (2, 5, 3, 64, 64, torch.bfloat16, True),
    (2, 37, 2, 64, 64, torch.float32, False),
]
# fp32 outputs (y in fp32, the state, dw, du, d init_state) within 1e-5 (y,
# state) and 1e-4 (gradients) of their max: the sums' order differs; bf16
# outputs also round once to bf16 (2e-2, the reference's bf16 tolerance)
WKV_FP32_TOL, WKV_GRAD_TOL = 1e-5, 1e-4


@pytest.mark.parametrize("b,s,h,dk,dv,dtype,init", WKV_CASES)
def test_rwkv6_forward_kernel_matches_plain(dev, b, s, h, dk, dv, dtype, init):
    from repro_torch.kernels import rwkv6_scan as r6
    r, k, v, w, u, s0 = _wkv_inputs(dev, b, s, h, dk, dv, dtype, init)
    before = r6.launches["rwkv6_scan_fwd"]
    y, state = r6.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert r6.launches["rwkv6_scan_fwd"] == before + 1
    assert y.shape == (b, s, h, dv) and y.dtype == dtype
    assert state.shape == (b, h, dk, dv) and state.dtype == torch.float32
    y_p, state_p = ref.rwkv6_scan_plain(r, k, v, w, u, s0)
    assert _rel_max(state, state_p) <= WKV_FP32_TOL
    if dtype == torch.float32:
        assert _rel_max(y, y_p) <= WKV_FP32_TOL
    else:
        torch.testing.assert_close(y.float(), y_p.float(), **TOL[dtype])


@pytest.mark.parametrize("b,s,h,dk,dv,dtype,init", WKV_CASES)
def test_rwkv6_forward_reruns_bitwise(dev, b, s, h, dk, dv, dtype, init):
    """The forward's sums run in a fixed order: a rerun gives the same bits."""
    from repro_torch.kernels import rwkv6_scan as r6
    ins = _wkv_inputs(dev, b, s, h, dk, dv, dtype, init)
    y, state = r6.rwkv6_scan(*ins)
    y2, state2 = r6.rwkv6_scan(*ins)
    assert torch.equal(y, y2) and torch.equal(state, state2)


@pytest.mark.parametrize("cotangents", ["both", "dy", "d_state"])
@pytest.mark.parametrize("b,s,h,dk,dv,dtype,init", WKV_CASES)
def test_rwkv6_backward_kernel_matches_plain(dev, b, s, h, dk, dv, dtype, init, cotangents):
    """The backward kernel against autograd of the plain version, from dy,
    from the final state's cotangent, or both."""
    from repro_torch.kernels import rwkv6_scan as r6
    r, k, v, w, u, s0 = _wkv_inputs(dev, b, s, h, dk, dv, dtype, init)
    g = torch.Generator(device=dev).manual_seed(1)
    dy = torch.randn((b, s, h, dv), generator=g, device=dev).to(dtype)
    ds = torch.randn((b, h, dk, dv), generator=g, device=dev)
    dy = None if cotangents == "d_state" else dy
    ds = None if cotangents == "dy" else ds
    before = r6.launches["rwkv6_scan_bwd"]
    got = r6._launch_bwd(r, k, v, w, u, s0, dy, ds)
    torch.cuda.synchronize()
    assert r6.launches["rwkv6_scan_bwd"] == before + 1
    want = ref.rwkv6_scan_plain_grads(r, k, v, w, u, s0, dy, ds)
    for name, a, e in zip(("dr", "dk", "dv", "dw", "du", "d_init"), got, want):
        assert a.shape == e.shape and a.dtype == e.dtype, name
        if not e.any():                          # no path from the given cotangent
            assert not a.any(), name
        elif a.dtype == torch.float32:
            assert _rel_max(a, e) <= WKV_GRAD_TOL, (name, _rel_max(a, e))
        else:
            scale = float(e.float().abs().max())
            torch.testing.assert_close(a.float() / scale, e.float() / scale, rtol=2e-2,
                                       atol=2e-2, msg=name)


def test_rwkv6_function_runs_both_kernels(dev):
    """Autograd through `rwkv6_scan` on the card: one forward and one
    backward launch, the gradients of the plain version's autograd."""
    from repro_torch.kernels import rwkv6_scan as r6
    ins = _wkv_inputs(dev, 2, 50, 2, 64, 64, torch.float32, True)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    before = dict(r6.launches)
    y, state = r6.rwkv6_scan(*leaves)
    loss = (y * y).sum() + (state * state.sin()).sum()
    got = torch.autograd.grad(loss, leaves)
    assert {n: r6.launches[n] - before[n] for n in before} == {"rwkv6_scan_fwd": 1,
                                                               "rwkv6_scan_bwd": 1}
    plain = [t.clone().requires_grad_(True) for t in ins]
    y_p, state_p = ref.rwkv6_scan_plain(*plain)
    want = torch.autograd.grad((y_p * y_p).sum() + (state_p * state_p.sin()).sum(), plain)
    for a, e in zip(got, want):
        assert _rel_max(a, e) <= WKV_GRAD_TOL


def test_rwkv6_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels import rwkv6_scan as r6
    r, k, v, w, u, s0 = _wkv_inputs(dev, 1, 8, 2, 16, 16, torch.float32, True)
    with pytest.raises(TypeError):
        r6.rwkv6_scan(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(TypeError):
        r6.rwkv6_scan(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError):
        r6.rwkv6_scan(r, k, v, w, u.cpu())
    with pytest.raises(ValueError):
        r6.rwkv6_scan(r, k, v, w, u, s0[:, :1])
    # a strided view (a rank's heads of a whole tensor) is taken, made
    # contiguous: the same bits as the contiguous call
    strided = r6.rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)
    for a, e in zip(strided, r6.rwkv6_scan(r, k, v, w, u)):
        assert torch.equal(a, e)
    big = _wkv_inputs(dev, 1, 4, 1, 72, 16, torch.float32, False)
    with pytest.raises(ValueError):
        r6.rwkv6_scan(*big[:5])


def _rwkv_cfg(**kw):
    return dataclasses.replace(get_config("rwkv6-7b", reduced=True), **kw)


def test_rwkv_model_kernel_path_matches_plain_path(dev):
    """Reduced rwkv6 in bf16 compute: one forward launch per layer, and the
    kernel path within the bf16 tolerance of the plain path."""
    from repro_torch.kernels import rwkv6_scan as r6
    cfg = _rwkv_cfg(compute_dtype="bfloat16")
    bundle = build_model(cfg)
    model = bundle.init(seed=0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), device=dev)
    with torch.inference_mode():
        before = r6.launches["rwkv6_scan_fwd"]
        got, _ = bundle.forward(model, {"tokens": tokens})
        assert r6.launches["rwkv6_scan_fwd"] == before + cfg.n_layers
        ops.set_default_impl("plain")
        try:
            expect, _ = bundle.forward(model, {"tokens": tokens})
        finally:
            ops.set_default_impl(None)
    assert _rel_max(got, expect) <= 2e-2


def test_rwkv_prefill_decode_matches_forward_on_card(dev):
    """Prefill + one-token decode steps (each a one-token scan from the
    carried state, through the kernel) == one forward, in fp32 compute."""
    from repro_torch.kernels import rwkv6_scan as r6
    cfg = _rwkv_cfg()
    bundle = build_model(cfg)
    model = bundle.init(seed=0, device=dev)
    S, n_dec = 40, 4
    tokens = torch.randint(0, cfg.vocab_size, (2, S + n_dec), device=dev)
    with torch.inference_mode():
        full, _ = bundle.forward(model, {"tokens": tokens})
        before = r6.launches["rwkv6_scan_fwd"]
        logits, cache = bundle.prefill(model, {"tokens": tokens[:, :S]})
        errs = [_rel_max(logits[:, -1], full[:, S - 1])]
        for t in range(S, S + n_dec):
            logits, cache = bundle.decode(model, cache, {"tokens": tokens[:, t:t + 1]})
            errs.append(_rel_max(logits[:, 0], full[:, t]))
        assert r6.launches["rwkv6_scan_fwd"] == before + (1 + n_dec) * cfg.n_layers
    assert cache["pos"] == S + n_dec
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("remat,fwd_per_pass", [("none", 1), ("full", 2)])
def test_reduced_rwkv_training_kernel_path_matches_plain_path(dev, remat, fwd_per_pass):
    """Reduced rwkv6 (fp32 compute) trains 3 AsyncSAM AdamW steps through the
    kernels: per step and layer the scan's forward runs once per gradient
    pass (twice under remat "full") and its backward once, and the run
    agrees with the plain path."""
    from repro_torch.core import MethodConfig
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.engine import Engine, FusedExecutor
    from repro_torch.launch.train import kernel_launches
    from repro_torch.optim import cosine_schedule, make_optimizer

    cfg = _rwkv_cfg(remat=remat)
    runs = {}
    for impl in ("plain", "kernel"):
        ops.set_default_impl(impl)
        try:
            bundle = build_model(cfg)
            ex = FusedExecutor(bundle.loss_fn, MethodConfig(rho=0.05),
                               make_optimizer("adamw", cosine_schedule(1e-3, 3)))
            state = ex.init_state(bundle.init(seed=0, device=dev), seed=1)
            pipe = TokenPipeline(cfg, PipelineConfig(global_batch=8, seq_len=64, seed=0,
                                                     ascent_fraction=0.25, prefetch=0),
                                 device=dev)
            before = kernel_launches(family="ssm")
            report = Engine(ex, pipe).fit(state, 3)
            after = kernel_launches(family="ssm")
        finally:
            ops.set_default_impl(None)
        runs[impl] = (report, {k: after[k] - before[k] for k in after})
    (rp, lp), (rk, lk) = runs["plain"], runs["kernel"]
    assert lp == dict.fromkeys(lp, 0)
    assert lk == {"rwkv6_scan_fwd": 3 * 2 * fwd_per_pass * cfg.n_layers,
                  "rwkv6_scan_bwd": 3 * 2 * cfg.n_layers, "sq_norm": 3, "sam_perturb": 0,
                  "fused_axpy": 3, "fused_dot_norms": 3, "adamw_epilogue": 3,
                  "sgd_epilogue": 0}
    for mp, mk in zip(rp.metrics_history, rk.metrics_history):
        for k in ("loss", "ascent_norm", "grad_norm"):
            assert mk[k] == pytest.approx(mp[k], rel=1e-4), k
    wp, wk = rp.final_state.params.buffers[0], rk.final_state.params.buffers[0]
    diff = (wk - wp).abs()
    assert float(torch.quantile(diff.float(), 0.999)) <= 1e-4 * float(wp.abs().max())
    assert float(diff.max()) <= 2 * 3 * 1e-3


# ---------------------------------------------------------------------------
# the Mamba2 SSD scan and its backward
# ---------------------------------------------------------------------------

def _ssd_inputs(dev, b, s, h, p, n, g, dtype, init, fast=False, seed=0):
    """x, b, c in `dtype`; dt = softplus(N(0, 1)), a = -linspace(1, 16, H)
    (the model's decay rates), d = 0.5, in fp32; with `fast` True the last
    head's dt is 20, so its decay exp(dt a) = exp(-320) underflows to 0; with
    `fast` "decades" every element of x, b and c is scaled by 10^u, u uniform
    in [-2, 2]; init_state fp32 or None."""
    g_ = torch.Generator(device=dev).manual_seed(seed)

    def n_(*shape, scale=1.0):
        t = torch.randn(shape, generator=g_, device=dev) * scale
        if fast == "decades":
            t = t * 10.0 ** (4 * torch.rand(shape, generator=g_, device=dev) - 2)
        return t

    x = n_(b, s, h, p, scale=0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g_, device=dev))
    if fast is True:
        dt[..., -1] = 20.0
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    bb, cc = n_(b, s, g, n, scale=0.3).to(dtype), n_(b, s, g, n, scale=0.3).to(dtype)
    d = torch.full((h,), 0.5, device=dev)
    s0 = torch.randn((b, h, p, n), generator=g_, device=dev) * 0.5 if init else None
    return x, dt, a, bb, cc, d, s0


# (B, S, H, P, N, G, dtype, init_state, fast decay): zamba2's head (P = N =
# 64) in bf16, a decode step (S = 1 from a state), ragged S from a state,
# G = 2 and H = 4 in fp32, a head whose decay underflows, widths that are
# not 16, 32 or 64 with G = H, zamba2's ascent scan shape (2 x 1024 tokens,
# 64 heads), five chunks of the kernels' 64 with a ragged last one, fp32 x,
# b, c spread over four decades (the backward's split products), and bf16
# widths that are not whole 16-byte vectors (the backward's element-by-element
# staging and stores)
SSD_CASES = [
    (2, 256, 4, 64, 64, 1, torch.bfloat16, False, False),
    (3, 1, 4, 64, 64, 1, torch.bfloat16, True, False),
    (1, 1000, 2, 64, 64, 1, torch.bfloat16, True, False),
    (2, 100, 4, 16, 16, 2, torch.float32, True, False),
    (2, 300, 8, 64, 64, 1, torch.float32, True, True),
    (2, 130, 4, 32, 24, 4, torch.float32, False, False),
    (2, 1024, 64, 64, 64, 1, torch.bfloat16, False, False),
    (2, 4 * 64 + 1, 4, 64, 64, 2, torch.bfloat16, True, False),
    (2, 200, 4, 64, 64, 2, torch.float32, True, "decades"),
    (2, 100, 4, 21, 18, 2, torch.bfloat16, True, False),
]
# fp32 outputs (y in fp32, the state, ddt, da, dd, d init_state; dx, db, dc
# in fp32) within 2e-4 of their max: the reference's own limit for its kernel
# against its sequential oracle (tests/test_kernels.py), the sums' order
# differing; bf16 outputs also round once to bf16 (2e-2, the reference's
# bf16 tolerance). da, a sum over B and S of terms that can cancel to a
# small da, is held to the same 2e-4 against the plain version in float64
# (_f64): the plain version's own da in fp32 is up to 1e-4 of max|da| from
# it on the ragged case, too close to the limit to judge the kernel by.
SSD_TOL = 2e-4


def _f64(*tensors):
    """float64 copies (None stays None): the plain SSD's math in float64."""
    return [None if t is None else t.double() for t in tensors]


@pytest.mark.parametrize("b,s,h,p,n,g,dtype,init,fast", SSD_CASES)
def test_mamba2_forward_kernel_matches_plain(dev, b, s, h, p, n, g, dtype, init, fast):
    from repro_torch.kernels import mamba2_scan as m2
    x, dt, a, bb, cc, d, s0 = _ssd_inputs(dev, b, s, h, p, n, g, dtype, init, fast)
    before = m2.launches["mamba2_scan_fwd"]
    y, state = m2.mamba2_scan(x, dt, a, bb, cc, d, s0)
    torch.cuda.synchronize()
    assert m2.launches["mamba2_scan_fwd"] == before + 1
    assert y.shape == (b, s, h, p) and y.dtype == dtype
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    y_p, state_p = ref.mamba2_chunked_plain(x, dt, a, bb, cc, d, chunk=128, init_state=s0)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(state).all())
    assert _rel_max(state, state_p) <= SSD_TOL
    if dtype == torch.float32:
        assert _rel_max(y, y_p) <= SSD_TOL
    else:
        torch.testing.assert_close(y.float(), y_p.float(), **TOL[dtype])


def _ssd_cotangents(dev, x, state, cotangents, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    dy = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    ds = torch.randn(state.shape, generator=g, device=dev)
    return (None if cotangents == "d_state" else dy), (None if cotangents == "dy" else ds)


@pytest.mark.parametrize("cotangents", ["both", "dy", "d_state"])
@pytest.mark.parametrize("b,s,h,p,n,g,dtype,init,fast", SSD_CASES)
def test_mamba2_backward_kernel_matches_plain(dev, b, s, h, p, n, g, dtype, init, fast,
                                              cotangents):
    """The backward kernel against autograd of the plain version, from dy,
    from the final state's cotangent, or both."""
    from repro_torch.kernels import mamba2_scan as m2
    x, dt, a, bb, cc, d, s0 = _ssd_inputs(dev, b, s, h, p, n, g, dtype, init, fast)
    dy, ds = _ssd_cotangents(dev, x, torch.empty((b, h, p, n), device=dev), cotangents)
    before = m2.launches["mamba2_scan_bwd"]
    got = m2._launch_bwd(x, dt, a, bb, cc, d, s0, dy, ds)
    torch.cuda.synchronize()
    assert m2.launches["mamba2_scan_bwd"] == before + 1
    want = ref.mamba2_scan_plain_grads(x, dt, a, bb, cc, d, s0, dy, ds, chunk=128)
    for name, g_, e in zip(("dx", "ddt", "da", "db", "dc", "dd", "d_init"), got, want):
        assert g_.shape == e.shape and g_.dtype == e.dtype, name
        assert bool(torch.isfinite(g_.float()).all()), name
        if not e.any():                          # no path from the given cotangent
            assert not g_.any(), name
        elif name == "da":
            witness = ref.mamba2_scan_plain_grads(*_f64(x, dt, a, bb, cc, d, s0, dy, ds),
                                                  chunk=128)[2]
            assert _rel_max(g_, witness) <= SSD_TOL, (name, _rel_max(g_, witness))
        elif g_.dtype == torch.float32:
            assert _rel_max(g_, e) <= SSD_TOL, (name, _rel_max(g_, e))
        else:
            scale = float(e.float().abs().max())
            torch.testing.assert_close(g_.float() / scale, e.float() / scale, rtol=2e-2,
                                       atol=2e-2, msg=name)


@pytest.mark.parametrize("b,s,h,p,n,g,dtype,init", [
    (4, 300, 8, 64, 64, 2, torch.bfloat16, True),
    (3, 1, 4, 64, 64, 1, torch.bfloat16, True),
    (2, 130, 4, 32, 24, 4, torch.float32, False),
])
def test_mamba2_forward_is_deterministic(dev, b, s, h, p, n, g, dtype, init):
    """The forward's phases sum in a fixed order (no atomics): two runs give
    the same bits."""
    from repro_torch.kernels import mamba2_scan as m2
    ins = _ssd_inputs(dev, b, s, h, p, n, g, dtype, init)
    first, second = m2.mamba2_scan(*ins), m2.mamba2_scan(*ins)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("s,kernels", [(1, 1), (64, 1), (65, 3)])
def test_mamba2_forward_kernel_count(dev, s, kernels):
    """A forward of one chunk (S <= 64: the decode step) is one CUDA kernel
    and allocates no scratch; a longer one launches its three phases."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import mamba2_scan as m2
    ins = _ssd_inputs(dev, 2, s, 4, 64, 64, 1, torch.bfloat16, True)
    assert (m2.fwd_buffers(ins[0], ins[3])["hbuf"] is None) == (kernels == 1)
    m2.mamba2_scan(*ins)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m2.mamba2_scan(*ins)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == kernels, names
    assert all("ssd_fwd_" in name for name in names), names


def test_mamba2_backward_sums_are_deterministic(dev):
    """db, dc (summed over the heads of a group), da and dd (over b and S)
    come from per-(b, h) partials reduced in a fixed order: two runs give
    the same bits."""
    from repro_torch.kernels import mamba2_scan as m2
    x, dt, a, bb, cc, d, s0 = _ssd_inputs(dev, 4, 300, 8, 64, 64, 2, torch.bfloat16, True)
    dy, ds = _ssd_cotangents(dev, x, s0, "both")
    first = m2._launch_bwd(x, dt, a, bb, cc, d, s0, dy, ds)
    second = m2._launch_bwd(x, dt, a, bb, cc, d, s0, dy, ds)
    for name, u, v in zip(("dx", "ddt", "da", "db", "dc", "dd", "d_init"), first, second):
        assert torch.equal(u, v), name


def test_mamba2_function_runs_both_kernels(dev):
    """Autograd through `mamba2_scan` on the card: one forward and one
    backward launch, the gradients of the plain version's autograd."""
    from repro_torch.kernels import mamba2_scan as m2
    ins = _ssd_inputs(dev, 2, 150, 4, 32, 32, 2, torch.float32, True)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    before = dict(m2.launches)
    y, state = m2.mamba2_scan(*leaves)
    loss = (y * y).sum() + (state * state.sin()).sum()
    got = torch.autograd.grad(loss, leaves)
    assert {k: m2.launches[k] - before[k] for k in before} == {"mamba2_scan_fwd": 1,
                                                               "mamba2_scan_bwd": 1}
    plain = [t.clone().requires_grad_(True) for t in ins]
    y_p, state_p = ref.mamba2_chunked_plain(*plain[:6], init_state=plain[6])
    want = torch.autograd.grad((y_p * y_p).sum() + (state_p * state_p.sin()).sum(), plain)
    f64 = [t.requires_grad_(True) for t in _f64(*ins)]
    y_w, state_w = ref.mamba2_chunked_plain(*f64[:6], init_state=f64[6])
    (da_w,) = torch.autograd.grad((y_w * y_w).sum() + (state_w * state_w.sin()).sum(), f64[2])
    for name, g_, e in zip(("dx", "ddt", "da", "db", "dc", "dd", "d_init"), got, want):
        if name == "da":
            e = da_w
        assert _rel_max(g_, e) <= SSD_TOL, (name, _rel_max(g_, e))


def test_mamba2_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels import mamba2_scan as m2
    x, dt, a, bb, cc, d, s0 = _ssd_inputs(dev, 1, 8, 4, 16, 16, 2, torch.float32, True)
    with pytest.raises(TypeError):
        m2.mamba2_scan(x.half(), dt, a, bb.half(), cc.half(), d)
    with pytest.raises(TypeError):
        m2.mamba2_scan(x, dt.bfloat16(), a, bb, cc, d)
    with pytest.raises(ValueError):
        m2.mamba2_scan(x, dt, a.cpu(), bb, cc, d)
    with pytest.raises(ValueError):
        m2.mamba2_scan(x, dt, a, bb, cc, d, s0[:, :1])
    with pytest.raises(ValueError):
        m2.mamba2_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, bb, cc, d)
    with pytest.raises(ValueError):                               # G must divide H
        m2.mamba2_scan(x[:, :, :3].contiguous(), dt[:, :, :3].contiguous(), a[:3], bb, cc,
                       d[:3])
    big = _ssd_inputs(dev, 1, 4, 2, 72, 16, 1, torch.float32, False)
    with pytest.raises(ValueError):
        m2.mamba2_scan(*big[:6])


def test_mamba2_refused_launch_raises(dev, monkeypatch):
    """A launch the kernel refuses (here: S = 0 reaching the C entry past the
    checks) returns its CUDA error, and the wrapper raises on it instead of
    counting a launch."""
    from repro_torch.kernels import mamba2_scan as m2
    x, dt, a, bb, cc, d, _ = _ssd_inputs(dev, 1, 8, 4, 16, 16, 2, torch.float32, False)
    before = dict(m2.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        m2._launch_fwd(x[:, :0], dt[:, :0], a, bb[:, :0], cc[:, :0], d, None)
    with pytest.raises(RuntimeError, match="launch failed"):
        m2._launch_bwd(x[:, :0], dt[:, :0], a, bb[:, :0], cc[:, :0], d, None, None, None)
    assert m2.launches == before


def _zamba_cfg(**kw):
    return dataclasses.replace(get_config("zamba2-1.2b", reduced=True), **kw)


# The kernel path against the plain path in bf16 compute, as a share of the
# logits' max: the two round to bf16 at other places (the flash kernel
# rounds P to bf16 before P V; the SSD kernel sums its chunks in another
# order) through reduced zamba2's 5 mamba and 3 shared blocks, each about
# bf16's own error from fp32. The olmo-1b logits' limit (chip_smoke.py); the
# control, the plain path with its weights at 6 significant bits (two fewer
# than bf16's), must fail it.
ZAMBA2_BF16_TOL = 5e-2


def _coarse_(model, bits):
    """Round every weight of `model` in place to `bits` significant bits."""
    drop = 24 - bits
    with torch.no_grad():
        for t in model.parameters():
            iv = t.data.view(torch.int32)
            iv.copy_((iv + (1 << (drop - 1))) & ~((1 << drop) - 1))
    return model


def test_zamba2_model_kernel_path_matches_plain_path(dev):
    """Reduced zamba2 in bf16 compute: one scan launch per mamba layer and
    one flash launch per shared-block invocation, the kernel path within
    ZAMBA2_BF16_TOL of the plain path, and the plain path at two bits less
    than bf16's precision outside it."""
    from repro_torch.kernels import mamba2_scan as m2
    cfg = _zamba_cfg(compute_dtype="bfloat16")
    bundle = build_model(cfg)
    model = bundle.init(seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), device=dev, generator=gen)
    with torch.inference_mode():
        before = (m2.launches["mamba2_scan_fwd"], fa.launches)
        got, _ = bundle.forward(model, {"tokens": tokens})
        assert (m2.launches["mamba2_scan_fwd"] - before[0], fa.launches - before[1]) == (
            cfg.n_layers, 3)
        ops.set_default_impl("plain")
        try:
            expect, _ = bundle.forward(model, {"tokens": tokens})
            control, _ = bundle.forward(_coarse_(bundle.init(seed=0, device=dev), 6),
                                        {"tokens": tokens})
        finally:
            ops.set_default_impl(None)
    err, ctl = _rel_max(got, expect), _rel_max(control, expect)
    print(f"zamba2 bf16 logits: kernel path {err}, control {ctl} (limit {ZAMBA2_BF16_TOL})")
    assert err <= ZAMBA2_BF16_TOL < ctl, (err, ctl)


def test_zamba2_prefill_decode_matches_forward_on_card(dev):
    """Prefill + one-token decode steps (each a one-token scan from the
    carried state, through the kernel) == one forward, in fp32 compute."""
    from repro_torch.kernels import mamba2_scan as m2
    cfg = _zamba_cfg()
    bundle = build_model(cfg)
    model = bundle.init(seed=0, device=dev)
    S, n_dec = 40, 4
    tokens = torch.randint(0, cfg.vocab_size, (2, S + n_dec), device=dev)
    with torch.inference_mode():
        full, _ = bundle.forward(model, {"tokens": tokens})
        before = m2.launches["mamba2_scan_fwd"]
        logits, cache = bundle.prefill(model, {"tokens": tokens[:, :S]}, pad_to=S + n_dec)
        errs = [_rel_max(logits[:, -1], full[:, S - 1])]
        for t in range(S, S + n_dec):
            logits, cache = bundle.decode(model, cache, {"tokens": tokens[:, t:t + 1]})
            errs.append(_rel_max(logits[:, 0], full[:, t]))
        assert m2.launches["mamba2_scan_fwd"] == before + (1 + n_dec) * cfg.n_layers
    assert cache["pos"] == S + n_dec
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("remat,fwd_per_pass", [("none", 1), ("full", 2)])
def test_reduced_zamba2_training_kernel_path_matches_plain_path(dev, remat, fwd_per_pass):
    """Reduced zamba2 (fp32 compute) trains 3 AsyncSAM AdamW steps through
    the kernels: per step and mamba layer the scan's forward runs once per
    gradient pass (twice under remat "full") and its backward once, flash
    once per pass and invocation, and the run agrees with the plain path."""
    from repro_torch.core import MethodConfig
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.engine import Engine, FusedExecutor
    from repro_torch.launch.train import kernel_launches
    from repro_torch.optim import cosine_schedule, make_optimizer

    cfg = _zamba_cfg(remat=remat)
    runs = {}
    for impl in ("plain", "kernel"):
        ops.set_default_impl(impl)
        try:
            bundle = build_model(cfg)
            ex = FusedExecutor(bundle.loss_fn, MethodConfig(rho=0.05),
                               make_optimizer("adamw", cosine_schedule(1e-3, 3)))
            state = ex.init_state(bundle.init(seed=0, device=dev), seed=1)
            pipe = TokenPipeline(cfg, PipelineConfig(global_batch=8, seq_len=64, seed=0,
                                                     ascent_fraction=0.25, prefetch=0),
                                 device=dev)
            before = kernel_launches(family="hybrid")
            report = Engine(ex, pipe).fit(state, 3)
            after = kernel_launches(family="hybrid")
        finally:
            ops.set_default_impl(None)
        runs[impl] = (report, {k: after[k] - before[k] for k in after})
    (rp, lp), (rk, lk) = runs["plain"], runs["kernel"]
    assert lp == dict.fromkeys(lp, 0)
    assert lk == {"flash_attention": 3 * 2 * 3,
                  "mamba2_scan_fwd": 3 * 2 * fwd_per_pass * cfg.n_layers,
                  "mamba2_scan_bwd": 3 * 2 * cfg.n_layers, "sq_norm": 3, "sam_perturb": 0,
                  "fused_axpy": 3, "fused_dot_norms": 3, "adamw_epilogue": 3,
                  "sgd_epilogue": 0}
    for mp, mk in zip(rp.metrics_history, rk.metrics_history):
        for k in ("loss", "ascent_norm", "grad_norm"):
            assert mk[k] == pytest.approx(mp[k], rel=1e-4), k
    wp, wk = rp.final_state.params.buffers[0], rk.final_state.params.buffers[0]
    diff = (wk - wp).abs()
    assert float(torch.quantile(diff.float(), 0.999)) <= 1e-4 * float(wp.abs().max())
    assert float(diff.max()) <= 2 * 3 * 1e-3
