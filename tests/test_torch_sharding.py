"""Port parity for the sharding rules (`repro_torch.models.partitioning`,
`repro_torch.launch.sharding`): every leaf's PartitionSpec against the
reference's, in process.

The rules read only `mesh.shape[axis]` and `mesh.axis_names`, so both
packages run on stand-in mesh objects at the production meshes, with no
devices: (4, 2), (16, 16) and (2, 16, 16). The reference's trees come from
`jax.eval_shape` (its stacked block leaves, (L, ...)); the port's from its
meta-device init (a module per block). A port block leaf "blocks.3.attn.wq"
must carry the reference's spec of "blocks/attn/wq" with the leading L entry
dropped, and that entry must be None (no rule shards the layer axis).
"""
import jax
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core import MethodConfig as JMethodConfig
from repro.core import init_train_state as jax_init_train_state
from repro.core import make_method as jax_make_method
from repro.launch import sharding as jsharding
from repro.models import build_model as jax_build_model
from repro.models import synth_batch as jax_synth_batch
from repro.models.partitioning import make_rules as jax_make_rules
from repro.models.partitioning import param_partition_spec as jax_param_partition_spec
from repro.utils.trees import _path_str
from repro.utils.trees import tree_map_with_path as jax_tree_map_with_path
from repro_torch import optim
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import MethodConfig, init_train_state, make_method
from repro_torch.launch import sharding
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.partitioning import P, make_rules, param_partition_spec
from repro_torch.utils import buckets


class StandIn:
    """What the rules read of a mesh: shape (axis -> size), axis_names."""

    def __init__(self, sizes, names):
        self.shape, self.axis_names = dict(zip(names, sizes)), tuple(names)


MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes():
    return [(StandIn(*m), Mesh(m[1], m[0])) for m in MESHES.values()]


def _norm(spec) -> tuple:
    """Spec entries compared by meaning: each a tuple of axis names (jax
    writes a one-axis entry as the bare name) or None, trailing Nones
    dropped."""
    out = [None if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _jax_specs(spec_tree) -> dict:
    """path -> spec entries of the reference's spec tree."""
    out = {}

    def note(path, spec):
        out["/".join(_path_str(k) for k in path)] = _norm(spec)

    jax.tree_util.tree_map_with_path(
        note, spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return out


def _port_specs(tree, prefix="") -> dict:
    """(reference path, block or None) -> spec entries of the port's tree."""
    out = {}
    if isinstance(tree, P):
        out[(prefix, None)] = tuple(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            path, block = buckets.reference_path(str(k))
            sub = "/".join(filter(None, (prefix, "/".join(path))))
            if block is not None:
                out[(sub, block)] = tuple(v)   # normalized by the caller
            else:
                out.update(_port_specs(v, sub))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for n, v in zip(tree._fields, tree):
            out.update(_port_specs(v, "/".join(filter(None, (prefix, n)))))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_port_specs(v, "/".join(filter(None, (prefix, str(i))))))
    return out


def _assert_same(jspecs: dict, pspecs: dict, skip=("rng",)) -> int:
    """Every reference leaf against the port's leaves of its path; returns
    the number of leaves compared."""
    by_path: dict = {}
    for (path, block), spec in pspecs.items():
        by_path.setdefault(path, {})[block] = spec
    n = 0
    for path, want in jspecs.items():
        if path.split("/")[-1] in skip:
            continue
        got = by_path.pop(path, None)
        assert got is not None, f"the port has no leaf {path}"
        if None in got:
            assert _norm(got[None]) == want, (path, got[None], want)
        else:
            assert sorted(got) == list(range(len(got))), path
            assert not want or want[0] is None, (path, want)
            for block, spec in got.items():
                assert _norm((None, *spec)) == want, (path, block, spec, want)
        n += 1
    leftover = {p for p in by_path if p.split("/")[-1] not in skip}
    assert not leftover, f"port leaves the reference lacks: {sorted(leftover)}"
    return n


def test_both_packages_list_the_same_archs():
    assert tuple(ARCH_IDS) == tuple(JARCH_IDS) and len(ARCH_IDS) == 10


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_specs_match_the_reference(arch, reduced):
    """params, the AdamW and SGD-momentum states and the AsyncSAM carry:
    every leaf at (4, 2), (16, 16) and (2, 16, 16)."""
    jcfg, cfg = jax_get_config(arch, reduced=reduced), get_config(arch, reduced=reduced)
    key = jax.random.PRNGKey(0)
    jparams = jax.eval_shape(lambda: jax_build_model(jcfg).init(key))
    model = build_model(cfg).init(device="meta")
    jmethod = jax_make_method(JMethodConfig(name="async_sam"))
    method = make_method(MethodConfig(name="async_sam", fused_update=False))
    n = 0
    for jopt, opt in ((joptim.adamw(1e-3), optim.adamw(1e-3)),
                      (joptim.sgd(1e-2, momentum=0.9), optim.sgd(1e-2, momentum=0.9))):
        jstate = jax.eval_shape(lambda: jax_init_train_state(jparams, jopt, jmethod, key))
        state = init_train_state(model, opt, method, 1, resident=False)
        assert all(t.device.type == "meta" for t in state.params.values())
        for jmesh, mesh in _meshes():
            n += _assert_same(_jax_specs(jsharding.state_spec_tree(jstate, jcfg, jmesh)),
                              _port_specs(sharding.state_spec_tree(state, cfg, mesh)))
    for jmesh, mesh in _meshes():
        n += _assert_same(_jax_specs(jsharding.state_spec_tree(jparams, jcfg, jmesh)),
                          _port_specs(sharding.state_spec_tree(model.state_dict(), cfg, mesh)))
        # the table itself, on the reference's paths and stacked shapes
        rules, jrules = make_rules(mesh), jax_make_rules(jmesh)
        jax_tree_map_with_path(
            lambda p, l: np.testing.assert_equal(
                _norm(param_partition_spec(p, l.shape, rules)),
                _norm(jax_param_partition_spec(p, l.shape, jrules)), err_msg=p), jparams)
    assert n > 0


@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_the_reference(arch, batch):
    """The reduced decode cache (batch 8 shards over dp, batch 1 moves the
    sequence onto the idle axes) and a training batch with its ascent
    slice and stub inputs."""
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jcache = jax.eval_shape(lambda: jax_build_model(jcfg).init_cache(batch, 64, pos=63))
    cache = build_model(cfg).init_cache(batch, 64, pos=63, device="meta")
    jbatch = jax.eval_shape(lambda: jax_synth_batch(jcfg, batch, 16, jax.random.PRNGKey(0),
                                                    0.5))
    pbatch = jax.tree.map(lambda x: torch.empty(x.shape, device="meta"), jbatch)
    for jmesh, mesh in _meshes():
        _assert_same(_jax_specs(jsharding.cache_spec_tree(jcache, jcfg, jmesh)),
                     _port_specs(sharding.cache_spec_tree(cache, cfg, mesh)))
        _assert_same(_jax_specs(jsharding.batch_spec_tree(jbatch, jmesh)),
                     _port_specs(sharding.batch_spec_tree(pbatch, mesh)))


def test_param_rules_basics():
    """The reference's seven assertions (tests/test_sharding_dryrun.py)."""
    rules = make_rules(Mesh(("data", "model"), (4, 2)))
    assert param_partition_spec("blocks/attn/wq", (8, 64, 64), rules) == \
        P(None, ("data",), ("model",))
    assert param_partition_spec("blocks/mlp/wo_mlp", (8, 64, 64), rules) == \
        P(None, ("model",), ("data",))
    assert param_partition_spec("embedding/embed", (1000, 64), rules) == \
        P(("model",), ("data",))
    assert param_partition_spec("blocks/moe/we_in", (8, 4, 64, 32), rules) == \
        P(None, ("model",), ("data",), None)
    assert param_partition_spec("blocks/moe/we_in", (8, 3, 64, 32), rules) == \
        P(None, None, ("data",), ("model",))
    assert param_partition_spec("blocks/ln1/scale", (8, 64), rules) == P()
    assert param_partition_spec("embedding/embed", (51865, 64), rules) == \
        P(None, ("data",))


def test_to_placements_for_each_rule_kind():
    from torch.distributed.tensor import Replicate, Shard

    two = Mesh(("data", "model"), (4, 2))
    pod = Mesh(("pod", "data", "model"), (2, 16, 16))
    r, s = Replicate(), Shard
    cases = [
        (two, P(("data",), ("model",)), (s(0), s(1))),             # matmul weight
        (two, P(("model",), ("data",)), (s(1), s(0))),             # output projection
        (two, P(("model",), None, None), (r, s(0))),               # EP expert stack
        (two, P(None, ("model",)), (r, s(1))),                     # bias / conv over TP
        (two, P(("data",), None), (s(0), r)),                      # router, batch
        (two, P(), (r, r)),                                        # norm scale
        (pod, P(("pod", "data"), ("model",)), (s(0), s(0), s(1))),  # FSDP over pods
        (pod, P(None, ("pod", "data", "model")), (s(1), s(1), s(1))),  # batch-1 sequence
    ]
    for mesh, spec, want in cases:
        assert sharding.to_placements(spec, mesh) == want, (spec, want)
    # a tree keeps its structure, a BucketedState's buffers replicate
    tree = sharding.to_placements({"a": P(("data",), None), "b": [P()]}, two)
    assert tree == {"a": (s(0), r), "b": [(r, r)]}


def test_stream_cast_matches_the_reference():
    import dataclasses
    from repro.models.partitioning import stream_cast as jax_stream_cast
    from repro_torch.models.partitioning import stream_cast

    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "scale": rng.standard_normal(6).astype(np.float32),
            "ids": np.arange(6, dtype=np.int32).reshape(2, 3)}
    for on in (False, True):
        jcfg = dataclasses.replace(jax_get_config("olmo-1b", reduced=True), weight_stream_bf16=on)
        cfg = dataclasses.replace(get_config("olmo-1b", reduced=True), weight_stream_bf16=on)
        want = jax_stream_cast(jax.tree.map(jax.numpy.asarray, tree), jcfg)
        got = stream_cast({k: torch.from_numpy(v) for k, v in tree.items()}, cfg)
        for k in tree:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), (on, k)
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k]).astype(np.float32))


def test_stacked_leaves_take_the_reference_rule_at_the_stacked_shape():
    """A per-block 1-D leaf outside the tables would take the 1-D branch at
    its own shape; evaluated at (L, D), as the reference's stacked leaf, it
    takes the matmul branch, whose L entry the mesh does not divide here."""
    mesh = Mesh(("data", "model"), (4, 2))
    state = {"blocks.0.mixer.foo": torch.empty(6, device="meta"),
             "blocks.1.mixer.foo": torch.empty(6, device="meta"),
             "blocks.2.mixer.foo": torch.empty(6, device="meta"),
             "head.foo": torch.empty(6, device="meta")}
    specs = sharding.state_spec_tree(state, None, mesh)
    assert specs["blocks.0.mixer.foo"] == P(("model",))
    assert specs["head.foo"] == P(("model",))
    with pytest.raises(ValueError, match="stacked layer axis"):
        sharding.state_spec_tree({f"blocks.{i}.mixer.foo": torch.empty(6, device="meta")
                                  for i in range(4)}, None, mesh)
