"""Port parity for the flat-buffer weight-space slice: the plain versions of
sq_norm, fused_axpy, fused_dot_norms and adamw_epilogue against the JAX
package's Pallas kernels (interpret mode) and jnp oracles, and the bucket
layout against `repro.utils.buckets`, on the same numpy inputs.

Tolerances are the reference's own (tests/test_kernels.py): fp32 2e-5, bf16
2e-2. The Hopper kernels themselves are held against these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import fused_update as jfu
from repro.kernels import ref as jref
from repro.kernels import sam_perturb as jsp
from repro.models import build_model as jax_build_model
from repro.utils import buckets as jbuckets
from repro_torch.configs import get_config
from repro_torch.core.api import value_and_grad_acc
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import buckets

_DT = {"float32": (jnp.float32, torch.float32, np.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16)}
SIZES = [1, 1000, 65536, 3 * 65536 + 17]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)

_pallas_sq_norm = jax.jit(lambda g: jsp.sq_norm(g, interpret=True))
_pallas_axpy = jax.jit(lambda a, x, y: jfu.fused_axpy(a, x, y, interpret=True))
_pallas_dot_norms = jax.jit(lambda a, b: jfu.fused_dot_norms(a, b, interpret=True))
_pallas_adamw = jax.jit(lambda w, g, mu, nu, s, lr, c1, c2, wd: jfu.adamw_epilogue(
    w, g, mu, nu, s, lr, c1, c2, weight_decay=wd, interpret=True), static_argnums=8)
_jnp_adamw = jax.jit(lambda w, g, mu, nu, s, lr, c1, c2, wd: jref.adamw_epilogue_flat_jnp(
    w, g, mu, nu, s, lr, c1, c2, weight_decay=wd), static_argnums=8)


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _vec(n, dtype, seed, scale=1.0, positive=False):
    """The same values for both frameworks, rounded to `dtype` once in numpy."""
    rng = np.random.default_rng(seed)
    a = (rng.random(n) if positive else rng.standard_normal(n)).astype(np.float32) * scale
    a = a.astype(_DT[dtype][2])
    return jnp.asarray(a), torch.from_numpy(a.astype(np.float32)).to(_DT[dtype][1])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, *expects, tol):
    for e in expects:
        np.testing.assert_allclose(_np(got), _np(e), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_sq_norm_plain_matches_pallas_and_oracle(n, dtype):
    jg, tg = _vec(n, dtype, 0)
    got = ops.sq_norm(tg)
    assert got.dtype == torch.float32 and got.dim() == 0
    # a sum of n squares: relative to its size
    _close(got, _pallas_sq_norm(jg), jref.sq_norm_jnp(jg), tol=dict(rtol=2e-5, atol=0))


# sq_norm's CUDA sweep (csrc/sam_perturb.cu, flat_buffer.cuh): one CTA of 256
# threads per 4,096-element tile; a thread's vector q of a tile is elements
# (q 256 + t) 4 .. + 3
SQ_TILE, SQ_THREADS = 4096, 256
SQ_SIZES = [1, SQ_TILE - 1, SQ_TILE, SQ_TILE + 1, 5 * SQ_TILE + 3, 98_304, 1100 * SQ_TILE + 5]


def _tree(a):
    """The block sum's shuffle-down tree over the last axis (32 lanes)."""
    for half in (16, 8, 4, 2, 1):
        a = a[..., :half] + a[..., half:2 * half]
    return a[..., 0]


def _sq_norm_sweep(x, dtype):
    """sq_norm's CUDA partition in numpy at `dtype`: per tile, four sums a
    thread (one per vector slot, each vector's 4 elements in order), the
    block sum (warp trees, then warp 0's tree over the 8 warp sums) into the
    tile's partial; then the partials' sum (the wrapper's torch.sum; here
    numpy's). Elements past n add nothing, as the kernel skips them."""
    tiles = -(-x.size // SQ_TILE)
    xp = np.zeros(tiles * SQ_TILE, dtype)
    xp[:x.size] = x
    vec = xp.reshape(tiles, 4, SQ_THREADS, 4)                     # [tile, q, t, j]
    acc = np.zeros((tiles, 4, SQ_THREADS), dtype)
    for j in range(4):
        acc = acc + vec[..., j] * vec[..., j]
    thread = (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])   # (tiles, 256)
    warps = _tree(thread.reshape(tiles, 8, 32))
    partials = _tree(np.concatenate([warps, np.zeros((tiles, 24), dtype)], -1))
    return np.sum(partials, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SQ_SIZES)
def test_sq_norm_sweep_matches_pallas_and_oracle(n, dtype):
    """The CUDA kernel's partition and order, rendered by _sq_norm_sweep: in
    float64 within 1e-12 of the sum in float64; in fp32 within the
    reference's 2e-5 of its Pallas kernel (interpret mode) and its jnp
    oracle, as the plain version is held."""
    jg, tg = _vec(n, dtype, 3)
    x = tg.float().numpy()
    exact = float(np.sum(x.astype(np.float64) ** 2))
    got64 = _sq_norm_sweep(x.astype(np.float64), np.float64)
    assert abs(got64 - exact) <= 1e-12 * exact
    got = _sq_norm_sweep(x, np.float32)
    assert got.dtype == np.float32
    _close(got, _pallas_sq_norm(jg), jref.sq_norm_jnp(jg), tol=dict(rtol=2e-5, atol=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_axpy_plain_matches_pallas_and_oracle(n, dtype):
    jx, tx = _vec(n, "float32", 1)
    jy, ty = _vec(n, dtype, 2)
    got = ops.fused_axpy(torch.tensor(-0.37), tx, ty)
    assert got.dtype == ty.dtype and got.shape == (n,)
    _close(got, _pallas_axpy(-0.37, jx, jy), jref.axpy_flat_jnp(-0.37, jx, jy), tol=_tol(dtype))
    out = torch.empty_like(ty)
    assert ops.fused_axpy(-0.37, tx, ty, out=out) is out
    torch.testing.assert_close(out, got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_dot_norms_plain_matches_pallas_and_oracle(n, dtype):
    ja, ta = _vec(n, "float32", 3)
    jb, tb = _vec(n, dtype, 4)
    got = ops.fused_dot_norms(ta, tb)
    for g, p, o in zip(got, _pallas_dot_norms(ja, jb), jref.dot_norms_flat_jnp(ja, jb)):
        assert g.dtype == torch.float32
        scale = float(np.sqrt(_np(got[1]) * _np(got[2])))   # |<a,b>| <= |a||b|
        _close(g, p, o, tol=dict(rtol=2e-5, atol=2e-5 * scale))


@pytest.mark.parametrize("wd,clip", [(0.0, 1.0), (0.1, 0.6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_adamw_epilogue_plain_matches_pallas_and_oracle(n, dtype, wd, clip):
    jw, tw = _vec(n, dtype, 5)
    jg, tg = _vec(n, "float32", 6)
    jmu, tmu = _vec(n, "float32", 7, 0.1)
    jnu, tnu = _vec(n, "float32", 8, 0.01, positive=True)
    lr, c1, c2 = 1e-2, 0.19, 0.001999
    new = ref.adamw_epilogue_flat_plain(tw, tg, tmu, tnu, clip, lr, c1, c2, weight_decay=wd)
    args = (jw, jg, jmu, jnu, clip, lr, c1, c2, wd)
    for got, p, o, tol in zip(new, _pallas_adamw(*args), _jnp_adamw(*args),
                              (_tol(dtype), _tol("float32"), _tol("float32"))):
        _close(got, p, o, tol=tol)
    assert new[0].dtype == tw.dtype and new[1].dtype == new[2].dtype == torch.float32
    # ops updates the buffers in place and returns them
    bufs = (tw.clone(), tmu.clone(), tnu.clone())
    out = ops.adamw_epilogue(bufs[0], tg, bufs[1], bufs[2], torch.tensor(clip),
                             torch.tensor(lr), torch.tensor(c1), torch.tensor(c2),
                             weight_decay=wd)
    for o, b, e in zip(out, bufs, new):
        assert o is b
        torch.testing.assert_close(b, e, rtol=0, atol=0)


def test_impl_plain_is_forced_and_kernel_wrappers_take_cpu_to_plain():
    t = torch.arange(5, dtype=torch.float32)
    assert float(ops.sq_norm(t, impl="plain")) == float(ops.sq_norm(t)) == 30.0
    with pytest.raises(ValueError):
        ops.sq_norm(t, impl="pallas")


# ---------------------------------------------------------------------------
# buckets, on olmo-1b-reduced
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    jcfg, cfg = jax_get_config("olmo-1b", reduced=True), get_config("olmo-1b", reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return cfg, jparams, model


def _coalesced(layout: buckets.BucketLayout):
    """The port's groups with each reference leaf's per-block leaves merged:
    [(dtype, [(offset, size)...], size)]."""
    out = []
    for grp in layout.groups:
        spans = []
        for name, off, size in zip(grp.names, grp.offsets, grp.sizes):
            key = buckets.flatten_key(name)[0]
            if spans and spans[-1][0] == key:
                spans[-1][2] += size
            else:
                spans.append([key, off, size])
        out.append((grp.dtype, [(o, s) for _, o, s in spans], grp.size))
    return out


def test_bucket_layout_matches_reference(reduced):
    cfg, jparams, model = reduced
    jl = jbuckets.bucket_layout(jparams)
    layout = buckets.bucket_layout(dict(model.named_parameters()))
    assert layout.n_leaves == 1 + 7 * cfg.n_layers
    expect = [(g.dtype, list(zip(g.offsets, g.sizes)), g.size) for g in jl.groups]
    assert _coalesced(layout) == expect
    assert buckets.bucket_layout(dict(model.named_parameters())) is layout     # cached


def test_mixed_dtype_layout_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"b": rng.standard_normal((3, 2)).astype(ml_dtypes.bfloat16),
            "a": {"x": rng.standard_normal(4).astype(np.float32),
                  "y": rng.standard_normal((2, 2)).astype(ml_dtypes.bfloat16)},
            "c": rng.standard_normal(5).astype(np.float32)}
    jl = jbuckets.bucket_layout(jax.tree.map(jnp.asarray, tree))
    flat = {"b": tree["b"], "a.x": tree["a"]["x"], "a.y": tree["a"]["y"], "c": tree["c"]}
    tflat = {k: torch.from_numpy(v.astype(np.float32)).to(
        torch.bfloat16 if v.dtype != np.float32 else torch.float32) for k, v in flat.items()}
    layout = buckets.bucket_layout(tflat)
    assert [g.dtype for g in layout.groups] == [g.dtype for g in jl.groups] == [
        "bfloat16", "float32"]
    assert _coalesced(layout) == [(g.dtype, list(zip(g.offsets, g.sizes)), g.size)
                                  for g in jl.groups]
    assert layout.groups[0].names == ("a.y", "b")


def test_param_buffer_is_the_reference_buffer_bitwise(reduced):
    _, jparams, model = reduced
    jstate = jbuckets.BucketedState.from_tree(jparams)
    state = buckets.BucketedState.from_tree(dict(model.named_parameters()))
    assert len(state.buffers) == len(jstate.buffers) == 1
    np.testing.assert_array_equal(state.buffers[0].detach().numpy(),
                                  np.asarray(jstate.buffers[0]))
    # from_module: the model's parameters become views into the buffer
    clone = transformer.init_params(model.cfg, device="meta").to_empty(device="cpu")
    clone.load_state_dict(model.state_dict())
    resident = buckets.BucketedState.from_module(clone)
    np.testing.assert_array_equal(resident.buffers[0].detach().numpy(),
                                  state.buffers[0].detach().numpy())
    buf = resident.buffers[0]
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel() * buf.element_size()
    for p in clone.parameters():
        assert lo <= p.data_ptr() < hi
    with torch.no_grad():
        buf.zero_()
    assert all(float(p.detach().abs().max()) == 0.0 for p in clone.parameters())


def test_gradients_land_in_the_gradient_buffer(reduced):
    """Backward accumulates straight into the flat gradient buffer: each
    leaf's .grad is a view of its slot (no gather), and the buffer holds the
    gradients autograd computes on the module itself."""
    cfg, _, model = reduced
    bundle = build_model(cfg)
    params = buckets.BucketedState.from_tree(dict(model.named_parameters()))
    grads = params.zeros_like()
    gbuf = grads.buffers[0]
    lo, hi = gbuf.data_ptr(), gbuf.data_ptr() + gbuf.numel() * gbuf.element_size()
    seen = {}

    def loss_fn(leaves, batch, gen):
        seen.update(leaves)
        return bundle.loss_fn(leaves, batch, gen)

    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    (loss, _), out = value_and_grad_acc(loss_fn, 1)(params, batch, None, out=grads)
    assert out is grads and gbuf.data_ptr() == lo
    layout = params.layout.groups[0]
    for name, off in zip(layout.names, layout.offsets):
        g = seen[name].grad
        assert g.data_ptr() == lo + off * gbuf.element_size() and lo <= g.data_ptr() < hi
    ref_loss, _ = bundle.loss_fn(model, batch)
    expect = torch.autograd.grad(ref_loss, [dict(model.named_parameters())[n]
                                            for n in layout.names])
    torch.testing.assert_close(loss, ref_loss.detach())
    torch.testing.assert_close(gbuf, torch.cat([e.reshape(-1) for e in expect]),
                               rtol=1e-6, atol=1e-7)


def test_tree_helpers_match_reference():
    from repro.utils import trees as jtrees
    from repro_torch.utils import trees
    rng = np.random.default_rng(2)
    a = {"x": rng.standard_normal((3, 4)).astype(np.float32),
         "y": {"z": rng.standard_normal(5).astype(np.float32)}}
    b = {"x": rng.standard_normal((3, 4)).astype(np.float32),
         "y": {"z": rng.standard_normal(5).astype(np.float32)}}
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta = {"x": torch.from_numpy(a["x"]), "y": {"z": torch.from_numpy(a["y"]["z"])}}
    tb = {"x": torch.from_numpy(b["x"]), "y": {"z": torch.from_numpy(b["y"]["z"])}}
    assert trees.tree_size(ta) == jtrees.tree_size(ja) == 17
    np.testing.assert_allclose(float(trees.global_norm(ta)), float(jtrees.global_norm(ja)),
                               rtol=2e-6)
    np.testing.assert_allclose(float(trees.tree_cosine_similarity(ta, tb)),
                               float(jtrees.tree_cosine_similarity(ja, jb)), rtol=2e-5)
    z = trees.tree_zeros_like(ta, torch.bfloat16)
    assert z["y"]["z"].dtype == torch.bfloat16 and not z["x"].any()
    assert trees.tree_cast(ta, torch.bfloat16)["x"].dtype == torch.bfloat16
    # a BucketedState's leaves are its buffers, and it keeps its layout
    flat = {"x": ta["x"], "y.z": ta["y"]["z"]}
    state = buckets.BucketedState.from_tree(flat)
    np.testing.assert_allclose(float(trees.global_norm(state)),
                               float(jtrees.global_norm(ja)), rtol=2e-6)
    zs = trees.tree_zeros_like(state, torch.float32)
    assert zs.layout is state.layout and zs.buffers[0].shape == (17,)


def test_to_portable_gives_per_leaf_views(reduced):
    from repro_torch.core import MethodConfig, init_train_state, make_method
    from repro_torch.optim import adamw
    cfg, _, model = reduced
    state = init_train_state(dict(model.named_parameters()), adamw(1e-3),
                             make_method(MethodConfig()))
    portable = buckets.to_portable(state)
    assert type(portable) is type(state)
    assert set(portable.params) == set(dict(model.named_parameters()))
    for name, p in model.named_parameters():
        torch.testing.assert_close(portable.params[name], p.detach(), rtol=0, atol=0)
    assert set(portable.opt_state[0].mu) == set(portable.params)
    assert set(portable.method_state.ascent_grad) == set(portable.params)
