"""The port's dry run (`repro_torch.launch.dryrun`) and what it stands on,
against the reference: the collective cost model, the abstract state's
parameters, the placed arguments' bytes, the abstract trace against a real
one, a miniature dry run on a fake 4x2 mesh, the kernels' fake shapes and
the traced flops.

`repro.launch.dryrun` sets XLA_FLAGS to 512 host devices when it is
imported, so every use of it runs in a subprocess (`subprocess_py`); the
other reference pieces run in process on the CPU, meshless or on stand-in
meshes (the rules read only the mesh's shape).
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core import MethodConfig as JMethodConfig
from repro.core import init_train_state as jax_init_train_state
from repro.core import make_method as jax_make_method
from repro.engine import FusedExecutor as JFusedExecutor
from repro.engine import cost_analysis_dict as jax_cost_analysis_dict
from repro.launch import sharding as jsharding
from repro.models import batch_spec as jax_batch_spec
from repro.models import build_model as jax_build_model
from repro.utils import trees as jtrees
from repro.utils.trees import _path_str
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import MethodConfig
from repro_torch.engine import FusedExecutor, cost_analysis_dict
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flat, ref
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import rwkv6_scan as r6
from repro_torch.kernels import sam_perturb as sp
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_host_mesh, make_production_mesh
from repro_torch.models import SHAPES, build_model, synth_batch
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import make_optimizer
from repro_torch.utils import abstract, buckets, trees

REPO = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


# ---------------------------------------------------------------------------
# (1) the collective cost model
# ---------------------------------------------------------------------------

def test_collective_cost_bytes_is_the_reference_formula(subprocess_py):
    inventory = [{"kind": k, "bytes": b, "group": g} for k in KINDS for g in (1, 2, 16)
                 for b in (4096, 3 * 1024 * 1024 + 12)]
    out = subprocess_py(f"""
        import json
        from repro.launch.dryrun import collective_cost_bytes
        inv = {inventory!r}
        print(json.dumps([collective_cost_bytes([r]) for r in inv]
                         + [collective_cost_bytes(inv)]))
    """, devices=1)
    want = json.loads(out.strip().splitlines()[-1])
    got = [dryrun.collective_cost_bytes([r]) for r in inventory]
    got.append(dryrun.collective_cost_bytes(inventory))
    assert got == want


# ---------------------------------------------------------------------------
# (2) the abstract state's parameters, all ten archs at full size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_params_match_the_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jbundle = jax_build_model(jcfg)
    jex = JFusedExecutor(jbundle.loss_fn, JMethodConfig(name="async_sam", n_microbatches=4),
                         joptim.make_optimizer("adamw", 1e-3, clip_norm=1.0))
    jstate = jex.abstract_state(lambda: jbundle.init(jax.random.PRNGKey(0)),
                                jax.random.PRNGKey(1))
    bundle = build_model(cfg)
    ex = FusedExecutor(bundle.loss_fn, MethodConfig(name="async_sam", n_microbatches=4),
                       make_optimizer("adamw", 1e-3, clip_norm=1.0))
    state = ex.abstract_state(lambda: bundle.init(seed=0, device="cpu"), seed=1)
    assert buckets.is_bucketed(state.params)      # resident, as the live state
    assert all(abstract.is_fake(t) for t in abstract.tensors(state))
    assert trees.tree_size(state.params) == jtrees.tree_size(jstate.params)
    assert trees.tree_bytes(state.params) == jtrees.tree_bytes(jstate.params)


# ---------------------------------------------------------------------------
# (3) the placed arguments' bytes on 16x16, leaf by leaf
# ---------------------------------------------------------------------------

class StandIn:
    """What the reference's rules read of a mesh."""

    def __init__(self, sizes, names):
        self.shape, self.axis_names = dict(zip(names, sizes)), tuple(names)


def _local_bytes(shape, spec, sizes: dict, itemsize: int) -> int:
    n = 1
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        div = math.prod(sizes[a] for a in axes)
        assert dim % div == 0
        n *= dim // div
    return n * itemsize


def _jax_leaf_bytes(tree, spec_tree, sizes: dict) -> dict:
    """reference path -> bytes of its local shard."""
    out = {}
    specs = {}
    jax.tree_util.tree_map_with_path(
        lambda p, s: specs.__setitem__("/".join(_path_str(k) for k in p), s), spec_tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))

    def note(path, leaf):
        key = "/".join(_path_str(k) for k in path)
        if hasattr(leaf, "shape"):
            out[key] = _local_bytes(leaf.shape, specs[key], sizes, leaf.dtype.itemsize)

    jax.tree_util.tree_map_with_path(note, tree)
    return out


def _port_leaf_bytes(tree, prefix: str = "") -> dict:
    """reference path -> bytes of this rank's shard(s) of the port's leaves
    (a block leaf adds into its stacked path)."""
    out: dict = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = abstract.nbytes(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            path, block = buckets.reference_path(str(k))
            sub = "/".join(filter(None, (prefix, "/".join(path))))
            for p, n in _port_leaf_bytes(v, sub).items():
                out[p] = out.get(p, 0) + n
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            out.update(_port_leaf_bytes(v, "/".join(filter(None, (prefix, name)))))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_port_leaf_bytes(v, "/".join(filter(None, (prefix, str(i))))))
    return out


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x7b"])
def test_argument_bytes_are_the_reference_local_shards(arch):
    """The train_4k cell's per-device argument bytes on 16x16: every leaf the
    two states (and batches) share holds exactly the bytes of its local
    shard under the reference's specs; the leaves only one package has are
    named (none only the port's), and the whole is the sum of the leaves."""
    shape = SHAPES["train_4k"]
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    key = jax.random.PRNGKey(0)
    jparams = jax.eval_shape(lambda: jax_build_model(jcfg).init(key))
    jmethod = jax_make_method(JMethodConfig(name="async_sam", n_microbatches=4))
    jopt = joptim.make_optimizer("adamw", 1e-3, clip_norm=1.0)
    jstate = jax.eval_shape(lambda: jax_init_train_state(jparams, jopt, jmethod, key))
    jbatch = jax_batch_spec(jcfg, shape, ascent_fraction=0.25)
    jmesh = StandIn((16, 16), ("data", "model"))
    want = _jax_leaf_bytes(jstate, jsharding.state_spec_tree(jstate, jcfg, jmesh), jmesh.shape)
    want.update({f"batch/{k}": v for k, v in _jax_leaf_bytes(
        jbatch, jsharding.batch_spec_tree(jbatch, jmesh), jmesh.shape).items()})

    with fake_world(256):
        mesh = make_production_mesh(device="cpu")
        _, state, batch = dryrun.train_inputs(cfg, shape, mesh,
                                              MethodConfig(n_microbatches=4), device="cpu")
        got = _port_leaf_bytes(state)
        got.update({f"batch/{k}": v for k, v in _port_leaf_bytes(batch).items()})
        total = abstract.storage_bytes((state, batch))
    shared = sorted(set(got) & set(want))
    assert len(shared) > 20
    for path in shared:
        assert got[path] == want[path], (path, got[path], want[path])
    port_only = sorted(set(got) - set(want))
    print(f"{arch}: {len(shared)} leaves shared; only in the port: {port_only}; "
          f"only in the reference: {sorted(set(want) - set(got))}")
    assert not port_only
    # the reference's 0-d device scalars that the port keeps as host values
    # (the step counter, the seed, the carry's flag and age)
    assert set(want) - set(got) == {"step", "rng", "method_state/have_ascent",
                                     "method_state/staleness"}
    assert total == sum(got.values())


# ---------------------------------------------------------------------------
# (4) the abstract trace is the real path
# ---------------------------------------------------------------------------

def _shapes(tree) -> list:
    if isinstance(tree, dict):
        return sorted((k, tuple(v.shape), str(v.dtype)) for k, v in tree.items()
                      if isinstance(v, torch.Tensor))
    return [(tuple(t.shape), str(t.dtype)) for t in abstract.tensors(tree)]


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b"])
def test_fake_trace_equals_the_real_trace(arch):
    cfg = get_config(arch, reduced=True)
    bundle = build_model(cfg)

    def executor():
        return FusedExecutor(bundle.loss_fn, MethodConfig(name="async_sam", n_microbatches=2),
                             make_optimizer("adamw", 1e-3, clip_norm=1.0))

    def batch_of():
        b = synth_batch(cfg, 8, 16, seed=3, device="cpu")
        b["ascent"] = synth_batch(cfg, 2, 16, seed=4, device="cpu")
        return b

    ex = executor()
    state = ex.abstract_state(lambda: bundle.init(seed=0, device="cpu"), seed=1)
    assert all(abstract.is_fake(t) for t in abstract.tensors(state))
    with abstract.fake_mode_of(state):
        batch = batch_of()
    (fstate, fmetrics), fake = abstract.trace(ex._make_step(), state, batch)

    rex = executor()
    rstate = rex.init_state(bundle.init(seed=0, device="cpu"), seed=1)
    (rstate, rmetrics), real = abstract.trace(rex._make_step(), rstate, batch_of())
    assert not any(abstract.is_fake(t) for t in abstract.tensors(rstate))
    assert fake.ops == real.ops and sum(fake.ops.values()) > 1000
    assert fake.flops == real.flops > 0
    assert (fake.argument_bytes, fake.peak_bytes, fake.output_bytes, fake.bytes_accessed) \
        == (real.argument_bytes, real.peak_bytes, real.output_bytes, real.bytes_accessed)
    assert _shapes(fmetrics) == _shapes(rmetrics)
    assert _shapes(fstate) == _shapes(rstate)
    # FusedExecutor.lower traces the same step
    assert ex.lower(state, batch).ops == fake.ops


# ---------------------------------------------------------------------------
# (5) a miniature dry run on a fake 4x2 mesh, the reference test's shapes
# ---------------------------------------------------------------------------

def _gathered_bytes(leaves, mesh, keep=None) -> int:
    """Result bytes of gathering each DTensor leaf whole (or but for mesh dim
    `keep`, whose shard stays), one all-gather a sharded mesh dim, the last
    mesh dim first (DTensor's order)."""
    sizes = mesh.device_mesh.shape
    total = 0
    for x in leaves:
        n = abstract.nbytes(x)
        for d in reversed(range(len(sizes))):
            if x.placements[d].is_shard() and d != keep:
                n *= sizes[d]
                total += n
    return total


def test_mini_dryrun_train_and_decode(tmp_path):
    cfg = get_config("olmo-1b", reduced=True)
    train = ShapeSpec("mini_train", "train", 64, 8)
    decode = ShapeSpec("mini_decode", "decode", 64, 8)
    mcfg = MethodConfig(n_microbatches=2)
    with fake_world(8):
        mesh = make_host_mesh(2, device="cpu")
        assert mesh.live and mesh.sharded and mesh.shape == {"data": 4, "model": 2}
        _, state, _ = dryrun.train_inputs(cfg, train, mesh, mcfg, device="cpu")
        params = list(state.params.values())
        lowered = dryrun.lower_cell(cfg, train, mesh, mcfg, device="cpu")
        gathers = sum(r["bytes"] for r in lowered.collectives if r["kind"] == "all-gather")
        # the tensor-parallel layout: every leaf of reduced olmo-1b (the
        # blocks' projections and the tied embedding; its norms have no
        # parameters) is consumed on its "model" shard, so each is gathered
        # over "data" only, layer by layer, by each of the 4 loss calls (2
        # microbatches of the descent batch, 2 of the ascent batch), the
        # embedding twice (the lookup and the logits); the descent batch's
        # two leaves move whole for each of its 2 global microbatches (its 2
        # ascent rows do not divide "data": they lie on every rank)
        embed = state.params["embedding.embed"]
        rows = 2 * 2 * 8 * 64 * 4
        assert gathers == 4 * _gathered_bytes(params + [embed], mesh, keep=1) + rows
        assert any(r["kind"] == "all-reduce" and r["group"] == 2 for r in lowered.collectives)
        assert lowered.flops > 0 and lowered.peak_bytes > lowered.argument_bytes

        args = dryrun.serve_inputs(cfg, decode, mesh, device="cpu")
        dlow = dryrun.lower_cell(cfg, decode, mesh, mcfg, device="cpu")
        dgathers = sum(r["bytes"] for r in dlow.collectives if r["kind"] == "all-gather")
        # the weights over "data" only (the embedding twice), the cache not
        # at all (placed on its rows and its kv heads, as each rank computes
        # on it), and this rank's 2 rows of the logits over "model"
        cache = [t for t in trees.tree_leaves(args[1]["layers"])]
        assert all(str(t.placements) == "(Shard(dim=1), Shard(dim=3))" for t in cache)
        weights = list(args[0].values()) + [args[0]["embedding.embed"]]
        assert dgathers == _gathered_bytes(weights, mesh, keep=1) + 2 * cfg.vocab_size * 4
    res = dryrun.run_cell("olmo-1b", "decode_32k", device="cpu", save=False, verbose=False,
                          cfg_override=cfg)
    assert res.status == "ok", res.note
    # a real group starts in the same process afterwards
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        t = torch.ones(3)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
        assert make_host_mesh(device="cpu").shape == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (6) each kernel's custom op: its fake outputs are its plain version's
# ---------------------------------------------------------------------------

def _meta(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


def _fake_and_plain(fn_fake, fn_plain, make):
    """fn on fake cuda tensors (the op's fake implementation) and the plain
    version on real CPU tensors of the same shapes."""
    real = make("cpu")
    with abstract.fake_mode():
        fake = make("cuda")
        got = fn_fake(*fake)
    return got, fn_plain(*real)


def _t(shape, dtype=torch.float32):
    return lambda dev: torch.randn(shape, device=dev).to(dtype)


@pytest.mark.parametrize("shape", [(2, 64, 4, 32, 2, 32), (1, 80, 8, 64, 8, 48)])
def test_flash_op_fake_shapes(shape):
    b, s, h, hd, kv, hd_v = shape

    def make(dev):
        return [_t((b, s, h, hd), torch.bfloat16)(dev), _t((b, s, kv, hd), torch.bfloat16)(dev),
                _t((b, s, kv, hd_v), torch.bfloat16)(dev)]

    got, want = _fake_and_plain(lambda q, k, v: fa.flash_attention(q, k, v),
                                lambda q, k, v: ref.flash_attention_plain(q, k, v), make)
    assert got.device.type == "cuda" and _meta([got]) == _meta([want])
    assert fa.launches == 0


@pytest.mark.parametrize("n", [4096, 65536 * 3 + 17])
def test_flat_ops_fake_shapes(n):
    """sq_norm, sam_perturb, fused_axpy, fused_dot_norms, adamw_epilogue,
    sgd_epilogue, delta_amax and delta_encode_i8: the wrappers' results on
    fake cuda tensors against the plain versions'."""
    def make(dev):
        return [torch.randn(n, device=dev) for _ in range(4)] + [
            torch.randn(n, device=dev).to(torch.bfloat16)]

    cases = {
        "sq_norm": (lambda w, g, m, v, b: [sp.sq_norm(b)],
                    lambda w, g, m, v, b: [ref.sq_norm_plain(b)]),
        "sam_perturb": (lambda w, g, m, v, b: [sp.sam_perturb(b, g, 0.05, sp.sq_norm(g))],
                        lambda w, g, m, v, b: [ref.sam_perturb_flat_plain(b, g, 0.05,
                                                                          ref.sq_norm_plain(g))]),
        "fused_axpy": (lambda w, g, m, v, b: [fu.fused_axpy(0.1, g, b)],
                       lambda w, g, m, v, b: [ref.axpy_flat_plain(0.1, g, b)]),
        "fused_dot_norms": (lambda w, g, m, v, b: list(fu.fused_dot_norms(b, g)),
                            lambda w, g, m, v, b: list(ref.dot_norms_flat_plain(b, g))),
        "adamw_epilogue": (lambda w, g, m, v, b: list(fu.adamw_epilogue(b, g, m, v.abs(), 1.0,
                                                                        1e-3, 0.9, 0.99)),
                           lambda w, g, m, v, b: list(ref.adamw_epilogue_flat_plain(
                               b, g, m, v.abs(), 1.0, 1e-3, 0.9, 0.99))),
        "sgd_epilogue": (lambda w, g, m, v, b: list(fu.sgd_epilogue(w, b, m, 1.0, 1e-2,
                                                                    momentum=0.9)),
                         lambda w, g, m, v, b: list(ref.sgd_epilogue_flat_plain(
                             w, b, m, 1.0, 1e-2, momentum=0.9))),
        "delta_amax": (lambda w, g, m, v, b: [fu.delta_amax(b, g, m)],
                       lambda w, g, m, v, b: [ref.delta_amax_flat_plain(b, g, m)]),
        "delta_encode_i8": (lambda w, g, m, v, b: list(fu.delta_encode_i8(b, g, m, 0.25)),
                            lambda w, g, m, v, b: list(ref.delta_encode_i8_flat_plain(
                                b, g, m, 0.25))),
    }
    for name, (kernel, plain) in cases.items():
        got, want = _fake_and_plain(kernel, plain, make)
        assert all(abstract.is_fake(t) and t.device.type == "cuda" for t in got), name
        assert _meta(got) == _meta(want), name
    assert not any(sp.launches.values()) and not any(fu.launches.values())


@pytest.mark.parametrize("shape", [(2, 24, 2, 16, 16), (1, 1, 4, 64, 32)])
@pytest.mark.parametrize("init", [False, True])
def test_rwkv6_ops_fake_shapes(shape, init):
    b, s, h, k, v = shape

    def make(dev):
        ins = [_t((b, s, h, k), torch.bfloat16)(dev), _t((b, s, h, k), torch.bfloat16)(dev),
               _t((b, s, h, v), torch.bfloat16)(dev), -_t((b, s, h, k))(dev).abs(),
               _t((h, k))(dev)]
        return ins + [_t((b, h, k, v))(dev) if init else None,
                      _t((b, s, h, v), torch.bfloat16)(dev), _t((b, h, k, v))(dev)]

    got, want = _fake_and_plain(
        lambda *a: list(r6.rwkv6_scan(*a[:6])) + list(r6._launch_bwd(*a)),
        lambda *a: list(ref.rwkv6_scan_plain(*a[:5], init_state=a[5]))
        + list(ref.rwkv6_scan_plain_grads(*a)), make)
    assert _meta(got) == _meta(want)
    assert not any(r6.launches.values())


@pytest.mark.parametrize("shape", [(2, 130, 4, 16, 2, 8), (1, 1, 8, 64, 1, 64)])
@pytest.mark.parametrize("init", [False, True])
def test_mamba2_ops_fake_shapes(shape, init):
    bsz, s, h, p, g, n = shape

    def make(dev):
        ins = [_t((bsz, s, h, p), torch.bfloat16)(dev), _t((bsz, s, h))(dev).abs(),
               -_t((h,))(dev).abs(), _t((bsz, s, g, n), torch.bfloat16)(dev),
               _t((bsz, s, g, n), torch.bfloat16)(dev), _t((h,))(dev)]
        return ins + [_t((bsz, h, p, n))(dev) if init else None,
                      _t((bsz, s, h, p), torch.bfloat16)(dev), _t((bsz, h, p, n))(dev)]

    got, want = _fake_and_plain(
        lambda *a: list(m2.mamba2_scan(*a[:7])) + list(m2._launch_bwd(*a)),
        lambda *a: list(ref.mamba2_chunked_plain(*a[:6], chunk=64, init_state=a[6]))
        + list(ref.mamba2_scan_plain_grads(*a)), make)
    # the plain grads are (dx, ddt, da, db, dc, dd, ds0), the kernel's order
    assert _meta(got) == _meta(want)
    assert not any(m2.launches.values())


# ---------------------------------------------------------------------------
# (7) the traced flops: the matmuls by hand plus the flash formula
# ---------------------------------------------------------------------------

def test_train_step_flops_by_hand():
    """Reduced olmo-1b, one device, batch 8 x 64 (b' 2), the kernels' ops
    traced on fake CPU tensors. A layer's matmuls: q, k, v, o (4 d^2 a
    token) and the SwiGLU MLP (3 d f), and the tied logits (d V), each 2
    flops a multiply-add; backward twice the forward's (the reduced config
    checkpoints nothing). Attention is the flash op, 2 (hd + hd_v) a visible
    (query, key) pair and head; its backward is autograd of the plain
    version recomputed from q, k and v: its two products over every (query,
    key) pair of each kv block, forward, and twice that backward."""
    cfg = get_config("olmo-1b", reduced=True)
    assert cfg.remat == "none" and cfg.tie_embeddings and cfg.n_heads == cfg.n_kv_heads
    b, s, bp = 8, 64, 2
    bundle = build_model(cfg)
    with flat.trace_kernels():
        ex = FusedExecutor(bundle.loss_fn, MethodConfig(name="async_sam"),
                           make_optimizer("adamw", 1e-3, clip_norm=1.0))
        state = ex.abstract_state(lambda: bundle.init(seed=0, device="cpu"), seed=1)
        with abstract.fake_mode_of(state):
            batch = dryrun.batch_spec(cfg, ShapeSpec("t", "train", s, b), ascent_fraction=0.25,
                                      device="cpu")
        lowered = ex.lower(state, batch)
    d, f, v, hd, h, L = (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.resolved_head_dim,
                         cfg.n_heads, cfg.n_layers)
    tokens = (b + bp) * s
    dense = 3 * 2 * tokens * (L * (4 * d * d + 3 * d * f) + d * v)
    pairs = fa.visible_pairs(s, s, True, None)
    flash = 2 * (hd + hd) * h * pairs * L * (b + bp)
    plain_bwd = 3 * 2 * 2 * hd * h * s * s * L * (b + bp)
    assert lowered.kernels["flash_attention_fwd"] == 2 * L
    assert lowered.flops == dense + flash + plain_bwd
    assert cost_analysis_dict(lowered) == {"flops": float(lowered.flops),
                                           "bytes accessed": float(lowered.bytes_accessed)}

    # beside it, the reference's meshless XLA count for the same cell. XLA
    # counts more kinds of op: every elementwise one (norms, softmax, the
    # optimizer's epilogue) and its jnp attention oracle's masked blocks
    # whole. But its layers run as one `lax.scan`, and `cost_analysis` counts
    # a loop's body once, not once an iteration, so of the L layers' work it
    # sees one: its total lands between a quarter and twice the port's.
    jcfg = jax_get_config("olmo-1b", reduced=True)
    jbundle = jax_build_model(jcfg)
    jex = JFusedExecutor(jbundle.loss_fn, JMethodConfig(name="async_sam"),
                         joptim.make_optimizer("adamw", 1e-3, clip_norm=1.0))
    key = jax.random.PRNGKey(0)
    jstate = jex.abstract_state(lambda: jbundle.init(key), key)
    jbatch = jax_batch_spec(jcfg, ShapeSpec("t", "train", s, b), ascent_fraction=0.25)
    jflops = jax_cost_analysis_dict(jex.lower(jstate, jbatch).compile())["flops"]
    ratio = jflops / lowered.flops
    print(f"flops a step: port {lowered.flops:.6e} (matmuls {dense:.6e}, flash {flash:.6e}, "
          f"its plain backward {plain_bwd:.6e}); reference XLA {jflops:.6e}; ratio {ratio:.4f}")
    assert 0.25 < ratio < 2.0


# ---------------------------------------------------------------------------
# (8) the CLI writes an artifact
# ---------------------------------------------------------------------------

def test_cli_writes_an_ok_artifact():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    tag = f"test{os.getpid()}"
    path = dryrun.ARTIFACT_DIR / f"olmo-1b_train_4k_16x16_{tag}.json"
    try:
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                               "olmo-1b", "--shape", "train_4k", "--device", "cpu", "--tag",
                               tag], capture_output=True, text=True, timeout=600, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        rec = json.loads(path.read_text())
    finally:
        path.unlink(missing_ok=True)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["param_count"] == 1_176_764_416
    assert rec["flops"] > 0 and rec["collective_bytes"] > 0 and rec["n_collectives"] > 0
    assert {r["kind"] for r in rec["inventory"]} == {"all-gather", "all-reduce"}


def _pairs_by_loop(sq, sk, causal, window):
    total = 0
    for qi in range(sq):
        hi = min(sk, qi + 1) if causal else sk
        lo = max(0, qi - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


@pytest.mark.parametrize("sq,sk", [(1, 1), (37, 37), (64, 200), (200, 64), (1024, 1024)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 16, 4096])
def test_visible_pairs_closed_form(sq, sk, causal, window):
    """The flash flop formula's pair count against the row-by-row count."""
    assert fa.visible_pairs(sq, sk, causal, window) == _pairs_by_loop(sq, sk, causal, window)


def test_scan_flop_formulas():
    """The scans' ops' formulas under FlopCounterMode: the kernels' bounds'
    counts (a state element and step: 5 forward, 12 / 14 backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with abstract.fake_mode():
        r = torch.empty(2, 24, 4, 16, device="cuda", dtype=torch.bfloat16)
        w, u = torch.empty(2, 24, 4, 16, device="cuda"), torch.empty(4, 16, device="cuda")
        x = torch.empty(2, 130, 4, 16, device="cuda", dtype=torch.bfloat16)
        dt, a = torch.empty(2, 130, 4, device="cuda"), torch.empty(4, device="cuda")
        b = torch.empty(2, 130, 1, 8, device="cuda", dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as fc:
            y, _ = r6._launch_fwd(r, r, r, w, u, None)
            r6._launch_bwd(r, r, r, w, u, None, y, None)
            ym, _ = m2._launch_fwd(x, dt, a, b, b, a, None)
            m2._launch_bwd(x, dt, a, b, b, a, None, ym, None)
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert counts == {"repro_torch.rwkv6_scan_fwd": 5 * 2 * 24 * 4 * 16 * 16,
                      "repro_torch.rwkv6_scan_bwd": 12 * 2 * 24 * 4 * 16 * 16,
                      "repro_torch.mamba2_scan_fwd": 5 * 2 * 130 * 4 * 16 * 8,
                      "repro_torch.mamba2_scan_bwd": 14 * 2 * 130 * 4 * 16 * 8}
