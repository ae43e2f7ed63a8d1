"""The port's tree and bucket utilities (`repro_torch.utils.trees`,
`repro_torch.utils.buckets`) against their `repro.utils` counterparts on the
CPU: the same trees, drawn from a numpy seed, through both. Leafwise
arithmetic holds to fp32 2e-5; the flatten / unflatten and bucket round
trips hold bit for bit. `tree_random_like` draws from a torch generator, not
a JAX key, so it is held for shapes, dtypes and seed determinism only.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.utils import buckets as jbuckets
from repro.utils import trees as jtrees
from repro_torch.utils import buckets, trees

FP32 = dict(rtol=2e-5, atol=2e-5)


def _tree(seed: int, bf16: bool = False) -> dict:
    """A nested tree of numpy leaves (one bf16 leaf with `bf16`)."""
    rng = np.random.default_rng(seed)
    out = {"a": rng.standard_normal((3, 4)).astype(np.float32),
           "b": {"c": rng.standard_normal(5).astype(np.float32),
                 "d": rng.standard_normal((2, 3, 2)).astype(np.float32)}}
    if bf16:
        out["e"] = rng.standard_normal((4, 2)).astype(ml_dtypes.bfloat16)
    return out


def _flat(tree: dict) -> dict:
    """{"a": ..., "b": {"c": ...}} -> {"a": ..., "b.c": ...}: a mapping of
    names, the form the port's buckets take."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _flat(v).items()})
        else:
            out[k] = v
    return out


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(x) -> np.ndarray:
    """A leaf of either package as numpy (bf16 as its fp32 value)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _same_tree(got, want, **tol):
    gl = trees.tree_leaves(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        assert buckets.dtype_name(g.dtype) == jnp.dtype(w.dtype).name
        if tol:
            np.testing.assert_allclose(_np(g), _np(w), **tol)
        else:
            assert np.array_equal(_np(g), _np(w))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

LEAFWISE = {
    "tree_ones_like": (lambda t, a, b: t.tree_ones_like(a)),
    "tree_add": (lambda t, a, b: t.tree_add(a, b)),
    "tree_sub": (lambda t, a, b: t.tree_sub(a, b)),
    "tree_scale": (lambda t, a, b: t.tree_scale(a, -0.37)),
    "tree_axpy": (lambda t, a, b: t.tree_axpy(2.5, a, b)),
    "tree_where_true": (lambda t, a, b: t.tree_where(True, a, b)),
    "tree_where_false": (lambda t, a, b: t.tree_where(False, a, b)),
}


@pytest.mark.parametrize("name", sorted(LEAFWISE))
def test_leafwise_helpers_match_the_reference(name):
    fn = LEAFWISE[name]
    a, b = _tree(0), _tree(1)
    want = fn(jtrees, _to_jax(a), _to_jax(b))
    got = fn(trees, _to_torch(a), _to_torch(b))
    assert isinstance(got, dict) and set(got) == set(want)
    _same_tree(got, want, **FP32)


def test_tree_where_takes_a_device_scalar():
    a, b = _to_torch(_tree(0)), _to_torch(_tree(1))
    for pred, pick in ((torch.tensor(True), a), (torch.tensor(False), b)):
        got = trees.tree_where(pred, a, b)
        assert all(torch.equal(g, w) for g, w in
                   zip(trees.tree_leaves(got), trees.tree_leaves(pick)))


def test_leafwise_helpers_keep_a_bucketed_state():
    st = buckets.BucketedState.from_tree(_to_torch(_flat(_tree(2))))
    out = trees.tree_axpy(2.0, st, trees.tree_ones_like(st))
    assert buckets.is_bucketed(out) and out.layout == st.layout
    assert torch.equal(out.buffers[0], 2.0 * st.buffers[0] + 1.0)


@pytest.mark.parametrize("bf16", [False, True])
def test_flatten_to_vector_and_back_bit_for_bit(bf16):
    t = _tree(3, bf16=bf16)
    want = jtrees.tree_flatten_to_vector(_to_jax(t))
    got = trees.tree_flatten_to_vector(_to_torch(t))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    back = trees.tree_unflatten_from_vector(got, _to_torch(t))
    _same_tree(back, jtrees.tree_unflatten_from_vector(want, _to_jax(t)))
    _same_tree(back, _to_jax(t))


def test_flatten_to_vector_of_a_bucketed_state_is_its_buffers():
    st = buckets.BucketedState.from_tree(_to_torch(_flat(_tree(4))))
    vec = trees.tree_flatten_to_vector(st)
    assert torch.equal(vec, torch.cat(st.buffers))
    back = trees.tree_unflatten_from_vector(vec, st)
    assert buckets.is_bucketed(back) and torch.equal(back.buffers[0], st.buffers[0])


@pytest.mark.parametrize("bf16", [False, True])
def test_tree_random_like_shapes_dtypes_and_seed(bf16):
    like = _to_torch(_tree(5, bf16=bf16))
    draw = lambda seed, std=1.0: trees.tree_random_like(  # noqa: E731
        torch.Generator().manual_seed(seed), like, std)
    a, again, other = draw(11), draw(11), draw(12)
    ref = jtrees.tree_random_like(jax.random.PRNGKey(11), _to_jax(_tree(5, bf16=bf16)))
    for x, y, z, w, r in zip(*(trees.tree_leaves(t) for t in (a, again, other, like)),
                             jax.tree.leaves(ref)):
        assert x.shape == w.shape == tuple(r.shape) and x.dtype == w.dtype
        assert buckets.dtype_name(x.dtype) == jnp.dtype(r.dtype).name
        assert torch.equal(x, y) and not torch.equal(x, z)
    # std scales the draws of the same generator state (fp32 leaves exactly)
    scaled = draw(11, std=0.5)
    for x, s in zip(trees.tree_leaves(a), trees.tree_leaves(scaled)):
        if x.dtype == torch.float32:
            assert torch.equal(s, x * 0.5)
    # a standard normal: the pooled draws' moments
    pooled = torch.cat([trees.tree_flatten_to_vector(draw(s)) for s in range(40)])
    assert abs(float(pooled.mean())) < 0.1 and abs(float(pooled.std()) - 1.0) < 0.1


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

def _mixed() -> dict:
    """A flat mapping whose groups (fp32 and bf16) each hold several leaves."""
    t = _flat(_tree(6, bf16=True))
    rng = np.random.default_rng(7)
    t["f"] = rng.standard_normal((3, 3)).astype(ml_dtypes.bfloat16)
    return t


def test_tree_to_buckets_and_back_bit_for_bit():
    t = _mixed()
    jt = _to_jax(t)
    jl = jbuckets.bucket_layout(jt)
    want = jbuckets.tree_to_buckets(jt, jl)
    lay = buckets.bucket_layout(_to_torch(t))
    got = buckets.tree_to_buckets(_to_torch(t), lay)
    assert [g.dtype for g in lay.groups] == [g.dtype for g in jl.groups]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert buckets.dtype_name(g.dtype) == jnp.dtype(w.dtype).name
        assert np.array_equal(_np(g), _np(w))
    back = buckets.buckets_to_tree(got, lay, _to_torch(t))
    assert list(back) == list(lay.names)
    _same_tree(back, jbuckets.buckets_to_tree(want, jl, jt))
    _same_tree(back, jt)


def test_buckets_to_tree_casts_to_like():
    """A congruent fp32 tree (moments beside bf16 params) through the
    params' layout, and back to like's dtypes: the reference's values."""
    t = _mixed()
    jt = _to_jax(t)
    moments = {k: np.asarray(v, np.float32) * 3 for k, v in t.items()}
    jl = jbuckets.bucket_layout(jt)
    lay = buckets.bucket_layout(_to_torch(t))
    jb = jbuckets.tree_to_buckets(_to_jax(moments), jl)
    pb = buckets.tree_to_buckets(_to_torch(moments), lay)
    assert all(g.dtype == torch.float32 for g in pb)
    for g, w in zip(pb, jb):
        assert np.array_equal(_np(g), _np(w))
    _same_tree(buckets.buckets_to_tree(pb, lay, _to_torch(t)),
               jbuckets.buckets_to_tree(jb, jl, jt))


def test_tree_to_buckets_rejects_mixed_dtypes_within_a_group():
    t = _to_torch(_mixed())
    lay = buckets.bucket_layout(t)
    t["a"] = t["a"].double()
    with pytest.raises(AssertionError, match="mixed dtypes"):
        buckets.tree_to_buckets(t, lay)


def test_track_copies_counts_the_gathers_the_reference_counts():
    """Every group here holds several leaves, so the reference counts a
    gather for each, as the port does (2 bytes moved a payload byte). The
    port's scatter is views: no copy, 0 counted, where the reference counts
    one a group; a cast is a copy and counts."""
    t = _mixed()
    jt = _to_jax(t)
    jl = jbuckets.bucket_layout(jt)
    lay = buckets.bucket_layout(_to_torch(t))
    with jbuckets.track_copies() as want:
        jb = jbuckets.tree_to_buckets(jt, jl)
        jbuckets.buckets_to_tree(jb, jl, jt)
    with buckets.track_copies() as got:
        pb = buckets.tree_to_buckets(_to_torch(t), lay)
        views = buckets.buckets_to_tree(pb, lay, _to_torch(t))
    assert (got.gathers, got.gather_bytes) == (want.gathers, want.gather_bytes) == (
        2, 2 * sum(g.size * (4 if g.dtype == "float32" else 2) for g in lay.groups))
    assert want.scatters == 2 and (got.scatters, got.scatter_bytes) == (0, 0)
    assert all(v.untyped_storage().data_ptr() == pb[i].untyped_storage().data_ptr()
               for i, g in enumerate(lay.groups) for v in (views[n] for n in g.names))
    like32 = {k: v.float() for k, v in _to_torch(t).items()}
    with buckets.track_copies() as cast:
        buckets.buckets_to_tree(pb, lay, like32)
    bf16 = next(g for g in lay.groups if g.dtype == "bfloat16")
    assert (cast.scatters, cast.scatter_bytes) == (1, bf16.size * (2 + 4))
    assert cast.total_bytes == cast.scatter_bytes
    # outside the context nothing counts
    assert buckets._COPY_STATS is None


@pytest.mark.parametrize("resident", [True, False])
def test_track_copies_on_a_training_step(resident):
    """A fused AsyncSAM step of the MLP stand-in: bucket-resident state
    makes no conversion copy; per-leaf state gathers its operands into
    buckets for every flat-buffer call."""
    from repro_torch import optim
    from repro_torch.core import MethodConfig
    from repro_torch.engine import FusedExecutor
    from repro_torch.service.testing import mlp_init, mlp_loss

    rng = np.random.default_rng(8)
    batch = {"x": torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 4, 16))}
    batch["ascent"] = {k: v[:4] for k, v in batch.items()}
    ex = FusedExecutor(mlp_loss, MethodConfig(name="async_sam", rho=0.05),
                       optim.adamw(1e-3), resident=resident)
    state = ex.init_state(mlp_init(0, device="cpu"), 1)
    state, _ = ex.step(state, batch)
    with buckets.track_copies() as stats:
        ex.step(state, batch)
    assert ex.resident == resident
    if resident:
        assert (stats.gathers, stats.scatters, stats.total_bytes) == (0, 0, 0)
    else:
        assert stats.gathers > 0 and stats.gather_bytes > 0


def test_tree_view():
    t = _to_torch(_mixed())
    st = buckets.BucketedState.from_tree(t)
    view = buckets.tree_view(st)
    assert set(view) == set(t) and all(torch.equal(view[k], t[k]) for k in t)
    assert buckets.tree_view(t) is t


def test_rebucket_unchanged_layout_passes_buffers_through():
    st = buckets.BucketedState.from_tree(
        {"a": torch.arange(6, dtype=torch.float32), "b": torch.ones((2, 2))})
    rb = buckets.rebucket(st, st.layout)
    assert all(x is y for x, y in zip(rb.buffers, st.buffers))


def test_rebucket_regroups_across_dtype_buckets_as_the_reference():
    """The reference's regroup (tests/test_elastic.py): 'b' moves from the
    fp32 bucket into the bf16 one; the same buffers, bit for bit."""
    t = {"a": np.arange(6, dtype=np.float32),
         "b": np.arange(4, dtype=np.float32).reshape(2, 2),
         "c": np.arange(3).astype(ml_dtypes.bfloat16)}
    variant = {**t, "b": t["b"].astype(ml_dtypes.bfloat16)}
    jst = jbuckets.BucketedState.from_tree(_to_jax(t))
    want = jbuckets.rebucket(jst, jbuckets.bucket_layout(_to_jax(variant)))
    st = buckets.BucketedState.from_tree(_to_torch(t))
    lay = buckets.bucket_layout(_to_torch(variant))
    got = buckets.rebucket(st, lay)
    assert got.layout is lay and len(got.buffers) == len(want.buffers)
    for g, w in zip(got.buffers, want.buffers):
        assert buckets.dtype_name(g.dtype) == jnp.dtype(w.dtype).name
        assert np.array_equal(_np(g), _np(w))
    again = buckets.BucketedState.from_tree(_to_torch(variant), layout=lay)
    assert all(torch.equal(g, w) for g, w in zip(got.buffers, again.buffers))
    with pytest.raises(TypeError, match="BucketedState"):
        buckets.rebucket(_to_torch(t), lay)
    with pytest.raises(ValueError, match="congruent"):
        buckets.rebucket(st, buckets.bucket_layout({"a": torch.zeros(7)}))


def test_rebucket_one_span_is_a_view():
    """A target group that is one span of one source buffer is that slice."""
    st = buckets.BucketedState.from_tree(
        {"a": torch.arange(6, dtype=torch.float32), "b": torch.ones(3, dtype=torch.bfloat16),
         "c": torch.ones(2, dtype=torch.bfloat16)})
    lay = buckets.bucket_layout({"a": torch.zeros(6, dtype=torch.bfloat16),
                                 "b": torch.zeros(3, dtype=torch.bfloat16),
                                 "c": torch.zeros(2, dtype=torch.bfloat16)})
    got = buckets.rebucket(st, lay)
    assert len(got.buffers) == 1 and got.buffers[0].dtype == torch.bfloat16
    assert torch.equal(got.to_tree()["a"].float(), torch.arange(6, dtype=torch.float32))


@pytest.mark.parametrize("default", [None, True, False])
@pytest.mark.parametrize("override", [None, True, False])
def test_fused_path_switch_resolves_as_the_reference(default, override):
    """override > process default > the platform's (the port's is on; the
    reference's is on for a TPU only, off on this CPU)."""
    try:
        buckets.set_fused_default(default)
        jbuckets.set_fused_default(default)
        got = buckets.fused_path_enabled(override)
        want = jbuckets.fused_path_enabled(override)
    finally:
        buckets.set_fused_default(None)
        jbuckets.set_fused_default(None)
    if override is None and default is None:
        assert got is True and want is (jax.default_backend() == "tpu")
    else:
        assert got == want == (override if override is not None else default)


def test_fused_path_default_reaches_per_leaf_state_only():
    from repro_torch.core.perturb import on_fused_path
    t = _to_torch(_flat(_tree(9)))
    st = buckets.BucketedState.from_tree(t)
    try:
        buckets.set_fused_default(False)
        assert not on_fused_path(t, None) and on_fused_path(t, True)
        assert on_fused_path(st, None) and on_fused_path(st, False)
    finally:
        buckets.set_fused_default(None)
    assert on_fused_path(t, None) and not on_fused_path(t, False)
