"""Sharding rules: parameter, optimizer-state, batch and cache
PartitionSpecs per arch (counterpart of `repro.launch.sharding`).

Strategy: 2-axis FSDP x TP, the reference's rules.
  * matmul weights (..., d_in, d_out): d_in -> dp (FSDP), d_out -> "model"
    (TP); output projections (wo / wo_mlp / w_out / wv_c) transpose it.
  * embed (V, D): vocab -> "model", d -> dp.
  * expert stacks (L, E, d_in, d_out): experts -> "model" when E divides the
    model axis (EP), else TP over d_out.
  * biases / per-head vectors: last dim -> "model"; norm scales replicate.
  * a rule whose dim does not divide its mesh axes is dropped (replicated on
    that dim).
"dp" is ("pod", "data") on the multi-pod mesh, ("data",) on one pod.

The trees are the port's: a TrainState of NamedTuples, tuples and mappings
of port parameter names. A leaf's path is its path in the reference's tree
(`utils.trees.tree_paths`), and a block leaf ("blocks.3.attn.wq") takes the
rule of the reference's stacked leaf (L, ...) with its leading L entry
dropped: the rule is evaluated at the reference's shape, so every leaf gets
the reference's spec (no rule shards the L axis; `state_spec_tree` checks
that). Leaves are tensors (meta tensors too) or anything with a `.shape`;
host values (step, seed, flags) are replicated, P(). A bucket-resident node
is unsharded by construction (a sharded mesh refuses it), so its buffers
are P() too.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

from repro_torch.launch.mesh import axis_size, dp_axes
from repro_torch.models.partitioning import PartitionSpec as P
from repro_torch.models.partitioning import (make_rules, mamba_heads, param_partition_spec,
                                             sp_enabled, tp_enabled)
from repro_torch.utils import buckets

Tree = Any


def param_spec(path: str, shape: tuple, mesh, cfg=None) -> P:
    """PartitionSpec for one parameter leaf of the reference's tree."""
    return param_partition_spec(path, tuple(shape), make_rules(mesh))


def _fits(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def _maybe(spec_axes, dim, mesh):
    """Return spec entry if divisible else None (replicate)."""
    if spec_axes is None:
        return None
    return spec_axes if _fits(dim, mesh, spec_axes) else None


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and not isinstance(x, (Mapping, tuple, list))


def _ndim(x) -> int:
    return len(tuple(x.shape))


def _join(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def map_leaves(f: Callable[[str, Any, int], Any], tree: Tree, prefix: str = "") -> Tree:
    """`f(path, leaf, blocks)` on every leaf with a shape, the tree's
    structure kept; `blocks` is the count of the leaf's stacked group when
    it is a block leaf of a mapping of port names, else 0. Host values map
    to P()."""
    if isinstance(tree, P):
        return tree
    if buckets.is_bucketed(tree):
        return buckets.BucketedState(tuple(P() for _ in tree.buffers), tree.layout)
    if isinstance(tree, Mapping):
        refs = {k: buckets.reference_path(str(k)) for k in tree}
        counts: dict = {}
        for path, block in refs.values():
            if block is not None:
                counts[path] = counts.get(path, 0) + 1
        out = {}
        for k, v in tree.items():
            path, block = refs[k]
            sub = _join(prefix, "/".join(path))
            if block is not None and _is_leaf(v):
                out[k] = f(sub, v, counts[path])
            else:
                out[k] = map_leaves(f, v, sub)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(f, v, _join(prefix, n))
                            for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(f, v, _join(prefix, str(i))) for i, v in enumerate(tree))
    if _is_leaf(tree):
        return f(prefix, tree, 0)
    return P()


def batch_spec_tree(batch_shapes: Tree, mesh) -> Tree:
    """Shard every batch leaf's leading (batch) dim over dp when divisible."""
    dp = dp_axes(mesh)

    def f(path, leaf, blocks):
        nd = _ndim(leaf)
        b = tuple(leaf.shape)[0] if nd else 1
        return P(_maybe(dp, b, mesh), *((None,) * (nd - 1)))

    return map_leaves(f, batch_shapes)


def cache_spec_tree(cache_shapes: Tree, cfg, mesh) -> Tree:
    """Decode/prefill cache sharding, the reference's rules.

    Attention K/V (L, B, S, K, hd) and MLA latents (L, B, S, R): batch -> dp
    when divisible; the sequence dim -> "model", and for a batch that does
    not divide (batch 1, long context) the sequence also takes the idle dp
    axes. States (ssm/wkv/conv/shift): heads/channels -> "model", batch -> dp.
    """
    return map_leaves(lambda path, leaf, blocks: _cache_leaf_spec(path, leaf, mesh),
                      cache_shapes)


def _cache_leaf_spec(path: str, leaf, mesh) -> P:
    dp = dp_axes(mesh)
    name = path.split("/")[-1]
    nd, shape = _ndim(leaf), tuple(leaf.shape)
    if nd == 0:
        return P()
    if name in ("k", "v", "cross_k", "cross_v", "c_kv", "k_rope"):
        # stacked (L,B,S,...) vs per-dense-layer (B,S,...)
        if name in ("k", "v", "cross_k", "cross_v"):
            off = 1 if nd == 5 else 0
        else:  # MLA latents: (L,B,S,R) stacked, (B,S,R) unstacked
            off = 1 if nd == 4 else 0
        b, s = shape[off], shape[off + 1]
        b_ax = _maybe(dp, b, mesh)
        if b_ax is None:
            s_ax = _maybe(dp + ("model",), s, mesh) or _maybe("model", s, mesh)
        else:
            s_ax = _maybe("model", s, mesh)
        spec = [None] * nd
        spec[off], spec[off + 1] = b_ax, s_ax
        return P(*spec)
    if name in ("ssm", "wkv"):
        # (L, B, H, P, N)
        spec = [None] * nd
        spec[1] = _maybe(dp, shape[1], mesh)
        spec[2] = _maybe("model", shape[2], mesh)
        return P(*spec)
    if name in ("conv_x", "conv_bc", "tm_shift", "cm_shift"):
        # (L, B, W-1|1, C)
        spec = [None] * nd
        spec[1] = _maybe(dp, shape[1], mesh)
        spec[-1] = _maybe("model", shape[-1], mesh)
        return P(*spec)
    return P(*([None] * nd))


def _tp_kv(cfg, mesh) -> bool:
    """Whether the serve step computes on local heads: the "tp" layout
    (`partitioning.tp_enabled`) with both head counts divisible by the
    "model" axis, and a cache with heads (attention's k/v, the
    encoder-decoder's cross k/v too, or rwkv6's wkv state; MLA's latents
    have none)."""
    m = axis_size(mesh, "model") if "model" in mesh.axis_names else 1
    return (m > 1 and tp_enabled(cfg) and cfg.mla is None and cfg.n_heads % m == 0
            and cfg.n_kv_heads % m == 0)


def _is_kv(path: str) -> bool:
    return path.split("/")[-1] in ("k", "v", "cross_k", "cross_v") and path.split("/")[0] in (
        "layers", "dense_layers", "shared")


def _tp_mamba(cfg, mesh) -> bool:
    """Whether the serve step computes mamba2 on the rank's heads: the "tp"
    layout with "model" dividing them (`partitioning.tp_leaves`); the x
    conv's tail and the SSM state are then the rank's."""
    m = axis_size(mesh, "model") if "model" in mesh.axis_names else 1
    return m > 1 and tp_enabled(cfg) and cfg.ssm is not None and mamba_heads(cfg) % m == 0


def serve_cache_spec_tree(cache_shapes: Tree, cfg, mesh) -> Tree:
    """The placement the sharded serve step keeps a cache in
    (`launch.steps`): `cache_spec_tree`'s, but where attention computes on
    local kv heads (`_tp_kv`) a k/v leaf (.., B, S, K, hd), the cross k/v
    too, holds its kv-head dim over "model" (the sequence takes the dp axes
    when the batch does not divide them), so that each rank's cache is its
    heads' and decode moves none of it (rwkv6's wkv state is on its heads
    in `cache_spec_tree`'s already)."""
    dp, tp = dp_axes(mesh), _tp_kv(cfg, mesh)

    def f(path, leaf, blocks):
        if not (tp and _is_kv(path)):
            return _cache_leaf_spec(path, leaf, mesh)
        nd, shape = _ndim(leaf), tuple(leaf.shape)
        off = 1 if nd == 5 else 0
        b_ax = _maybe(dp, shape[off], mesh)
        out = [None] * nd
        out[off] = b_ax
        out[off + 1] = None if b_ax is not None else _maybe(dp, shape[off + 1], mesh)
        out[off + 2] = "model"
        return P(*out)

    return map_leaves(f, cache_shapes)


def _seq_kv(cfg, mesh) -> bool:
    """Whether the serve step attends over the cache's sequence blocks: on a
    "model" axis of more than one rank, the sequence-parallel layout
    (`partitioning.sp_enabled`), or the "tp" layout where the kv heads do
    not carry the cache (`_tp_kv` false: a head count "model" does not
    divide, or MLA's latents)."""
    m = axis_size(mesh, "model") if "model" in mesh.axis_names else 1
    return m > 1 and (sp_enabled(cfg) or (tp_enabled(cfg) and not _tp_kv(cfg, mesh)))


_SEQ_LEAVES = ("k", "v", "cross_k", "cross_v", "c_kv", "k_rope")


def compute_cache_spec_tree(cache_shapes: Tree, cfg, mesh, split: bool) -> Tree:
    """What each rank of the sharded serve step computes on of a cache: the
    batch dim over the dp axes when the batch splits over them (`split`),
    the heads over "model" where the model computes on its heads
    (`_tp_kv`: a k/v or cross k/v leaf's kv heads, rwkv6's wkv state's),
    mamba2's x-conv tail's channels and SSM state's heads where it computes
    on its heads (`_tp_mamba`), every other dim whole (rwkv6's token-shift
    states and mamba2's BC-conv tail, a few tokens wide, are gathered).
    Where attention runs over the cache's sequence blocks
    (`_seq_kv`) a k/v, cross k/v or MLA latent leaf keeps
    `_cache_leaf_spec`'s placement, its sequence on its blocks (over
    "model", or the dp axes and "model" where the batch does not split),
    so decode moves no byte of it."""
    dp, tp, seq = dp_axes(mesh), _tp_kv(cfg, mesh), _seq_kv(cfg, mesh)
    mamba = _tp_mamba(cfg, mesh)

    def f(path, leaf, blocks):
        nd = _ndim(leaf)
        if nd == 0:
            return P()
        if seq and path.split("/")[-1] in _SEQ_LEAVES:
            return _cache_leaf_spec(path, leaf, mesh)
        out = [None] * nd
        if split:   # the batch dim: after the layer axis but in "dense_layers"
            out[0 if path.startswith("dense_layers") else 1] = dp
        if tp and _is_kv(path):
            out[nd - 2] = "model"
        elif tp and path.split("/")[-1] == "wkv":   # (L, B, H, K, V)
            out[2] = "model"
        elif mamba and path.split("/")[-1] == "ssm":   # (L, B, H, P, N)
            out[2] = "model"
        elif mamba and path.split("/")[-1] == "conv_x":   # (L, B, d_conv - 1, d_inner)
            out[3] = "model"
        return P(*out)

    return map_leaves(f, cache_shapes)


def state_spec_tree(state_shapes: Tree, cfg, mesh) -> Tree:
    """TrainState sharding: params and the trees that mirror them (moments,
    momentum, the carried ascent gradient) by the parameter rules, matched
    on the path's last name; scalars and host values replicated."""
    rules = make_rules(mesh)

    def f(path, leaf, blocks):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        if not blocks:
            return param_partition_spec(path, shape, rules)
        spec = param_partition_spec(path, (blocks, *shape), rules)
        if spec and spec[0] is not None:
            raise ValueError(f"{path}: the rule {spec} shards the stacked layer axis, "
                             "which a per-block leaf cannot hold")
        return P(*spec[1:])

    return map_leaves(f, state_shapes)


def to_placements(spec_tree: Tree, mesh) -> Tree:
    """Each PartitionSpec as DTensor placements on `mesh` (one per mesh
    dim): Shard(d) on every mesh dim that tensor dim d's entry names (two
    names shard the dim over both, the first outermost), Replicate()
    elsewhere. The counterpart of the reference's `to_named`."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)

    def one(spec: P) -> tuple:
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            for axis in ((entry,) if isinstance(entry, str) else entry):
                out[names.index(axis)] = Shard(d)
        return tuple(out)

    return map_specs(one, spec_tree)


def map_specs(f: Callable[[P], Any], tree: Tree) -> Tree:
    """`f` on every PartitionSpec of a spec tree, its structure kept."""
    if isinstance(tree, P):
        return f(tree)
    if buckets.is_bucketed(tree):
        return buckets.BucketedState(tuple(f(s) for s in tree.buffers), tree.layout)
    if isinstance(tree, Mapping):
        return {k: map_specs(f, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(f, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(f, v) for v in tree)
    return tree
