"""Port parity for the JOB-delta wire: the plain versions of delta_amax and
delta_encode_i8 against the JAX package's Pallas kernels (interpret mode) and
jnp oracles, `_pow2_scale`, every frame the port encodes against the
reference's encoding of the same inputs, the exact length models, the
delta streams crossing between the packages' encoders and shadows, and the
2 GiB frame bound.

Tolerance: none. The delta path is bitwise by contract (the client's shadow
must equal the server's), so amax, q, s', e', the frames and the shadows are
compared bit for bit. The Hopper kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Compressor as JCompressor
from repro.kernels import fused_update as jfu
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro.service import delta as jdelta
from repro.service import protocol as jproto
from repro.utils import buckets as jbuckets
from repro_torch.configs import get_config
from repro_torch.core import Compressor
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, to_reference
from repro_torch.service import delta, protocol
from repro_torch.utils import buckets


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


_pallas_amax = jax.jit(lambda p, s, e: jfu.delta_amax(p, s, e, interpret=True))
_pallas_i8 = jax.jit(lambda p, s, e, sc: jfu.delta_encode_i8(p, s, e, sc, interpret=True))


def _inputs(n, dtype, seed=0):
    """p (rounded to `dtype` once in numpy), the shadow s near p, and a small
    residual e, as numpy arrays both frameworks take."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    if dtype == "bfloat16":
        p = p.astype(ml_dtypes.bfloat16)
    s = (p.astype(np.float32) + 0.01 * rng.standard_normal(n)).astype(np.float32)
    e = (1e-3 * rng.standard_normal(n)).astype(np.float32)
    return p, s, e


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 1000, 65536, 200_001])
def test_delta_kernels_plain_match_pallas_and_oracle_bitwise(n, dtype):
    p, s, e = _inputs(n, dtype)
    amax = ops.delta_amax(_torch(p), _torch(s), _torch(e), impl="plain")
    j_amax = _pallas_amax(jnp.asarray(p), jnp.asarray(s), jnp.asarray(e))
    assert float(amax) == float(j_amax) == float(jref.delta_amax_flat_jnp(p, s, e))
    scale = delta._pow2_scale(float(amax))
    assert scale == jdelta._pow2_scale(float(j_amax))
    st, et = _torch(s), _torch(e)
    q, s2, e2 = ops.delta_encode_i8(_torch(p), st, et, float(scale), impl="plain")
    assert s2 is st and e2 is et and q.dtype == torch.int8      # in place
    for expect in (_pallas_i8(jnp.asarray(p), jnp.asarray(s), jnp.asarray(e), scale),
                   jref.delta_encode_i8_flat_jnp(p, s, e, scale)):
        for got, want in zip((q, s2, e2), expect):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_delta_nonfinite_params(bad):
    """A NaN reaches the amax (then `_pow2_scale` gives 1.0), as jnp.max's
    does; q, s' and e' follow the jnp oracle, whose cast of NaN to int8 gives
    q = 0 (s' = s there: what the server's numpy apply of that q gives). The
    Pallas kernel advances s by the float q instead, NaN; only its amax and
    q are held here."""
    p, s, e = _inputs(1000, "float32", seed=1)
    p[[3, 517]] = bad
    args = [_torch(x) for x in (p, s, e)]
    amax = float(ops.delta_amax(*args, impl="plain"))
    j_amax = float(_pallas_amax(jnp.asarray(p), jnp.asarray(s), jnp.asarray(e)))
    assert (math.isnan(amax) and math.isnan(j_amax)) if np.isnan(bad) else amax == j_amax
    scale = delta._pow2_scale(amax)
    assert scale == jdelta._pow2_scale(j_amax) == 1.0
    q, s2, e2 = ops.delta_encode_i8(*args, float(scale), impl="plain")
    oracle = jref.delta_encode_i8_flat_jnp(p, s, e, scale)
    for got, want in zip((q, s2, e2), oracle):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas_q = _pallas_i8(jnp.asarray(p), jnp.asarray(s), jnp.asarray(e), scale)[0]
    np.testing.assert_array_equal(q.numpy(), np.asarray(pallas_q))


@pytest.mark.parametrize("amax", [0.0, 1e-30, 1e-3, 0.5, 126.9, 127.0, 127.1, 3e5, 1e38,
                                  np.inf, np.nan])
def test_pow2_scale_matches_reference(amax):
    got, want = delta._pow2_scale(amax), jdelta._pow2_scale(amax)
    assert got.dtype == want.dtype == np.float32 and got == want


# ---------------------------------------------------------------------------
# frames: the port encodes the reference's bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_get_config("olmo-1b", reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree.map(np.asarray, jparams))
    model = transformer.init_params(get_config("olmo-1b", reduced=True), device="meta")
    model = model.to_empty(device="cpu")
    model.load_state_dict(sd)
    return jparams, buckets.BucketedState.from_module(model)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def test_wire_tree_of_a_resident_state_is_the_references(reduced):
    """`host_portable` of the port's resident state is the reference's
    `host_portable` of its own: the same keys in the same order, shapes,
    dtypes and bytes, hence the same snapshot payload."""
    jparams, state = reduced
    host = buckets.host_portable(state)
    jhost = jbuckets.host_portable(jbuckets.BucketedState.from_tree(jparams))
    leaves, treedef = buckets.host_flatten(host)
    jleaves, jtreedef = jax.tree.flatten(jhost)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b))
    assert buckets.host_unflatten(treedef, leaves).keys() == jax.tree.unflatten(
        jtreedef, jleaves).keys()
    key = np.array([7, 9], np.uint32)
    assert (protocol.encode_trees({}, params=host, batch=_batch(), rng=key)
            == jproto.encode_trees({}, params=jhost, batch=_batch(), rng=key))
    # the host buckets the server derives equal the client's device buckets
    layout = buckets.host_layout(host)
    assert [g.size for g in layout.groups] == [g.size for g in state.layout.groups]
    for hb, db in zip(buckets.host_tree_to_buckets(host, layout), state.buffers):
        np.testing.assert_array_equal(hb, db.numpy())
    np.testing.assert_array_equal(
        jbuckets.host_tree_to_buckets(jhost, jbuckets.bucket_layout(jhost))[0],
        buckets.host_tree_to_buckets(host, layout)[0])


def _grad_leaves(seed=0, shapes=((4, 3), (7,), (2, 2, 5), (1,))):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("kind,frac", [("none", 0.01), ("int8", 0.01), ("topk", 0.3)])
@pytest.mark.parametrize("pool", [None, (3, 0.25)])
def test_grad_frames_and_length_model_match_reference(kind, frac, pool):
    leaves = _grad_leaves()
    got = protocol.encode_frame(protocol.FrameType.GRAD, protocol.encode_grad(
        5, 11, 1.25, 0.5, leaves, Compressor(kind, frac), pool=pool))
    want = jproto.encode_frame(jproto.FrameType.GRAD, jproto.encode_grad(
        5, 11, 1.25, 0.5, leaves, JCompressor(kind, frac), pool=pool))
    assert got == want
    tree = {f"l{i}": x for i, x in enumerate(leaves)}
    assert (len(got) == protocol.grad_frame_bytes(Compressor(kind, frac), tree,
                                                  pool=pool is not None)
            == jproto.grad_frame_bytes(JCompressor(kind, frac), tree, pool=pool is not None))
    assert Compressor(kind, frac).wire_bytes(tree) == JCompressor(kind, frac).wire_bytes(tree)
    decoded = protocol.decode_grad(got[protocol.FRAME_HEADER_BYTES:], pool=pool is not None)
    jdecoded = jproto.decode_grad(want[16:], pool=pool is not None)
    for a, b in zip(decoded[4], jdecoded[4]):
        np.testing.assert_array_equal(a, b)
    # a 0-d leaf goes out as shape (1,) (np.ascontiguousarray makes it 1-d),
    # 4 bytes past both packages' length model: the same bytes either way
    scalar = _grad_leaves(1, shapes=((),))
    frame = protocol.encode_grad(0, 0, 1.0, 0.0, scalar, Compressor(kind, frac), pool=pool)
    assert frame == jproto.encode_grad(0, 0, 1.0, 0.0, scalar, JCompressor(kind, frac), pool=pool)


def test_control_frames_match_reference():
    for comp in (Compressor("none"), Compressor("int8"), Compressor("topk", 0.2)):
        jc = JCompressor(comp.kind, comp.topk_fraction)
        for kw in ({}, {"proto": None}, {"client_id": "c7", "group": "dp0", "generation": 3,
                                          "token": "s3cret", "extra": {"observe": True}}):
            assert protocol.encode_hello(comp, **kw) == jproto.encode_hello(jc, **kw)
    assert protocol.encode_resync("skew", 4) == jproto.encode_resync("skew", 4)
    assert protocol.encode_busy(2, 1, 9) == jproto.encode_busy(2, 1, 9)
    snap = {"workers": 2, "queue_capacity": 4, "queue_depth": 1,
            **{k: i + 1 for i, k in enumerate(protocol.STATS_COUNTER_KEYS)},
            "clients_detail": [{"uid": 5, "group_uid": 0, "exchanges": 3, "last_wait_s": 0.5}],
            "shadows_detail": [{"scope_uid": 9, "gen": 0, "sync": 2, "seq": 7, "replays": 1}]}
    got = protocol.encode_frame(protocol.FrameType.STATS, protocol.encode_stats(snap))
    assert got == jproto.encode_frame(jproto.FrameType.STATS, jproto.encode_stats(snap))
    assert len(got) == protocol.stats_frame_bytes(1, 1) == jproto.stats_frame_bytes(1, 1)
    assert protocol.decode_stats(got[16:]) == jproto.decode_stats(got[16:])


@pytest.mark.parametrize("encoding", ["none", "int8", "topk"])
def test_job_frames_and_length_models_match_reference(reduced, encoding):
    """v1 JOB, v2 snapshot and delta JOB_DELTA frames, and the exact length
    models, from the port's encoder's own EncodedJobs."""
    _, state = reduced
    key, batch = np.array([3, 4], np.uint32), _batch(1)
    enc = delta.JobEncoder(encoding, topk_fraction=0.1)
    jobs = [enc.encode(0, state, batch, key, step) for step in range(2)]
    host = buckets.host_portable(state)
    for job in jobs:
        args = (job.sync, job.seq, job.gen, job.step, job.batch, job.rng)
        kw = dict(params=job.params, kind=job.kind, deltas=job.deltas)
        got = protocol.encode_frame(protocol.FrameType.JOB_DELTA,
                                    protocol.encode_job_v2(*args, **kw))
        want = jproto.encode_frame(jproto.FrameType.JOB_DELTA, jproto.encode_job_v2(*args, **kw))
        assert got == want
        is_delta = job.kind != "snapshot"
        model = dict(delta=is_delta, topk_fraction=0.1)
        assert (len(got) == protocol.job_frame_bytes(encoding, host, batch, key, **model)
                == jproto.job_frame_bytes(encoding, host, batch, key, **model))
        assert (protocol.job_frame_breakdown(encoding, host, batch, key, **model)
                == jproto.job_frame_breakdown(encoding, host, batch, key, **model))
    assert [j.kind for j in jobs] == (["snapshot"] * 2 if encoding == "none"
                                      else ["snapshot", encoding])
    v1 = protocol.encode_job(2, 5, host, batch, key)
    assert v1 == jproto.encode_job(2, 5, host, batch, key)


# ---------------------------------------------------------------------------
# delta streams across the packages: bitwise shadows
# ---------------------------------------------------------------------------

def _drift(tree, rs, scale=0.01):
    return {k: _drift(v, rs, scale) if isinstance(v, dict)
            else (v + np.float32(scale) * rs.standard_normal(v.shape).astype(np.float32))
            for k, v in tree.items()}


def _feed(job, shadow, proto, frame_type):
    """Frame `job` with the client's package, decode and apply it with the
    server's (`proto`, `shadow`); returns the decoded kind."""
    payload = proto.encode_job_v2(job.sync, job.seq, job.gen, job.step, job.batch, job.rng,
                                  params=job.params, kind=job.kind, deltas=job.deltas)
    sync, seq, _, _, kind, params, _, _, sections = proto.decode_job_v2(payload)
    if kind == "snapshot":
        shadow.install(params, sync)
    else:
        shadow.apply(kind, sections, sync, seq)
    return kind


@pytest.mark.parametrize("encoding", ["int8", "topk"])
def test_port_encoder_feeds_reference_shadow_bitwise(reduced, encoding):
    _, state = reduced
    rs = np.random.RandomState(0)
    enc = delta.JobEncoder(encoding, topk_fraction=0.05)
    shadow = jdelta.ShadowState()
    key, batch = np.array([1, 2], np.uint32), _batch()
    kinds = []
    for step in range(5):
        job = enc.encode(0, state, batch, key, step)
        kinds.append(_feed(job, shadow, protocol, None))
        for mine, theirs in zip(enc.shadow_host(), shadow.bufs):
            np.testing.assert_array_equal(mine, theirs)
        with torch.no_grad():     # the params move, as a descent step moves them
            state.buffers[0].add_(0.01 * torch.from_numpy(
                rs.standard_normal(state.buffers[0].shape).astype(np.float32)))
    assert kinds == ["snapshot"] + [encoding] * 4
    assert enc.delta_jobs == 4 and enc.encode_failures == 0


@pytest.mark.parametrize("encoding", ["int8", "topk"])
def test_reference_encoder_feeds_port_shadow_bitwise(reduced, encoding):
    jparams, _ = reduced
    rs = np.random.RandomState(1)
    params = jax.tree.map(np.asarray, jparams)
    enc = jdelta.JobEncoder(encoding, topk_fraction=0.05)
    shadow = delta.ShadowState()
    key, batch = np.array([1, 2], np.uint32), _batch()
    kinds = []
    for step in range(5):
        job = enc.encode(0, params, batch, key, step)
        kinds.append(_feed(job, shadow, jproto, None))
        for mine, theirs in zip(shadow.bufs, enc._shadow):
            np.testing.assert_array_equal(mine, np.asarray(theirs))
        params = _drift(params, rs)
    assert kinds == ["snapshot"] + [encoding] * 4
    # the tree the port's server cuts from its shadow is the reference's
    cut = shadow.params()
    for a, b in zip(buckets.host_flatten(cut)[0], jax.tree.leaves(
            jbuckets.host_buckets_to_tree([np.asarray(s) for s in enc._shadow],
                                          enc._layout, enc._leaf_dtypes))):
        np.testing.assert_array_equal(a, b)


def test_layout_drift_degrades_to_a_snapshot_and_a_kernel_error_propagates(reduced,
                                                                           monkeypatch):
    _, state = reduced
    key, batch = np.array([1, 2], np.uint32), _batch()
    enc = delta.JobEncoder("int8")
    assert enc.encode(0, state, batch, key, 0).kind == "snapshot"
    smaller = {"w": torch.ones(5)}
    job = enc.encode(0, smaller, batch, key, 1)     # another layout: drift
    assert job.kind == "snapshot" and enc.encode_failures == 1
    assert enc.encode(0, smaller, batch, key, 2).kind == "int8"

    def broken(*a, **kw):
        raise RuntimeError("delta_amax kernel launch failed: CUDA error 98")

    monkeypatch.setattr(ops, "delta_amax", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        enc.encode(0, smaller, batch, key, 3)
    assert enc.encode_failures == 1


# ---------------------------------------------------------------------------
# the 2 GiB frame bound
# ---------------------------------------------------------------------------

def _abstract(shape, dtype=np.float32) -> np.ndarray:
    """A zero-stride stand-in of `shape`: the length models read only shapes
    and dtypes, so nothing of that size is allocated."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, dtype), shape=shape,
                                           strides=(0,) * len(shape))


@pytest.mark.parametrize("layers,fits", [(6, True), (7, False), (16, False)])
def test_snapshot_frame_bound_at_full_width(layers, fits):
    """Full-width olmo-1b's snapshot JOB carries 4 bytes a parameter; the
    reference bounds a frame's payload at 2 GiB, so 6 layers fit and 7 and
    the full 16 do not, in both packages (the counts from shapes only)."""
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=layers)
    model = transformer.init_params(cfg, device="meta")
    host = to_reference(dict(model.named_parameters()),
                        leaf=lambda t: _abstract(tuple(t.shape)),
                        empty=buckets.empty_modules(model))
    n = sum(p.numel() for p in model.parameters())
    assert n == 103_022_592 + layers * 67_108_864
    jcfg = dataclasses.replace(jax_get_config("olmo-1b"), n_layers=layers)
    jabs = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    batch = {"labels": _abstract((2, 1024), np.int32), "tokens": _abstract((2, 1024), np.int32)}
    key = np.zeros(2, np.uint32)
    got = protocol.job_frame_bytes("int8", host, batch, key, delta=False)
    assert got == jproto.job_frame_bytes("int8", jabs, batch, key, delta=False)
    assert got > 4 * n
    assert (got - protocol.FRAME_HEADER_BYTES < protocol._MAX_PAYLOAD) == fits
    assert protocol._MAX_PAYLOAD == jproto._MAX_PAYLOAD == 1 << 31
    # an int8 delta JOB of the same model is a quarter of it and fits
    assert protocol.job_frame_bytes("int8", host, batch, key) < protocol._MAX_PAYLOAD
