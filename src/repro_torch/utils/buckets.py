"""Flat-buffer (dtype-bucketed) training state (counterpart of
`repro.utils.buckets`).

The weight-space epilogue of a training step (perturb, global norm, clip,
Adam, weight decay, lr, apply) streams every parameter element through
device memory; the fused kernels in `repro_torch.kernels` work on flat
vectors, one per dtype. A `BucketedState` holds a tree of named tensors as
one contiguous buffer per dtype, and its leaves are views into the buffers.
The port's training state is always bucket-resident: parameters, gradients,
Adam moments and the AsyncSAM ascent gradient are BucketedStates, and the
step runs buffer -> buffer with no gather or scatter.

Layout. `bucket_layout` groups and orders the leaves exactly as the
reference does (`repro/utils/buckets.py:68-93`): groups sorted by dtype name,
leaves in JAX flatten order, i.e. sorted dict keys, where the reference's
stacked `blocks.*` leaf holds all L layers contiguously. The port keeps one
module per block (`blocks.<i>.attn.wq`), so the flatten key of a port name
drops the block index and then orders the layers. The port's buffer for a
model therefore equals the reference's `BucketedState.from_tree(params)`
buffer element for element.

The host edge (`host_portable`, `host_layout`, `host_tree_to_buckets`,
`host_buckets_to_tree`) is where the bucket-resident state meets the
reference's nested tree of numpy arrays, the form the ascent lanes and the
wire carry: the reference's tree flattens into its buckets in the same order,
so a stacked block leaf is a view of the host copy of a bucket, and the
buckets the ascent server derives from a snapshot's tree are the client's
device buckets byte for byte.

`track_copies` counts the gather and scatter copies the bucket code makes
(`CopyStats`); `fused_path_enabled` is the switch every flat-buffer call
site on per-leaf state consults (`set_fused_default` its process default).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops

Tree = Any


def dtype_name(dtype: torch.dtype) -> str:
    """"float32", "bfloat16", ...: the names jnp.dtype gives."""
    return str(dtype).removeprefix("torch.")


# the module lists whose blocks the reference stacks on a leading axis (a
# moe model's `dense_blocks` it keeps as a list: "dense_blocks/0/attn/wq")
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def reference_path(name: str) -> tuple[tuple[str, ...], Optional[int]]:
    """A port leaf name as (its path in the reference's tree, its block index
    or None): the reference stacks the blocks on a leading axis, so
    "blocks.3.attn.wq" is block 3 of the reference's leaf blocks/attn/wq
    (also `enc_blocks`, `dec_blocks`)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in STACKED and parts[1].isdigit():
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def flatten_key(name: str) -> tuple:
    """Sort key of a leaf name in the reference's flatten order: its path in
    the reference's tree, then the block index."""
    path, block = reference_path(name)
    return (path, block or 0)


@dataclasses.dataclass(frozen=True)
class BucketGroup:
    """One dtype bucket: which leaves it holds and where they live."""
    dtype: str                      # leaf dtype name (grouping key)
    names: tuple[str, ...]          # leaf names, flatten order
    offsets: tuple[int, ...]        # element offset of each leaf in the buffer
    sizes: tuple[int, ...]          # element count of each leaf
    size: int                       # total elements in the buffer


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    names: tuple[str, ...]                 # every leaf, flatten order
    shapes: tuple[tuple[int, ...], ...]    # per-leaf shapes (flatten order)
    groups: tuple[BucketGroup, ...]        # sorted by dtype name
    n_leaves: int
    # names of the model's parameterless modules (a non-parametric norm):
    # the reference's tree holds an empty dict there, which the wire carries
    empty: tuple[str, ...] = ()


_LAYOUT_CACHE: dict = {}


def bucket_layout(tree: Mapping[str, torch.Tensor]) -> BucketLayout:
    """Layout for a mapping of leaf name -> tensor, cached on (names,
    shapes, dtypes)."""
    names = tuple(sorted(tree, key=flatten_key))
    key = tuple((n, tuple(tree[n].shape), tree[n].dtype) for n in names)
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    by_dtype: dict[str, list[str]] = {}
    for n in names:
        by_dtype.setdefault(dtype_name(tree[n].dtype), []).append(n)
    groups = []
    for dname in sorted(by_dtype):
        members = by_dtype[dname]
        sizes = tuple(math.prod(tree[n].shape) for n in members)
        offsets, off = [], 0
        for s in sizes:
            offsets.append(off)
            off += s
        groups.append(BucketGroup(dtype=dname, names=tuple(members),
                                  offsets=tuple(offsets), sizes=sizes, size=off))
    layout = BucketLayout(names=names, shapes=tuple(tuple(tree[n].shape) for n in names),
                          groups=tuple(groups), n_leaves=len(names))
    _LAYOUT_CACHE[key] = layout
    return layout


def _shape_of(layout: BucketLayout) -> dict[str, tuple[int, ...]]:
    return dict(zip(layout.names, layout.shapes))


# ---------------------------------------------------------------------------
# Gather/scatter copy accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CopyStats:
    """Bytes the bucket code moves converting between a tree and buffers.

    Counted: every buffer a gather fills (`BucketedState.from_tree`, so
    `tree_to_buckets` and `group_buffers` on a mapping: the per-call regime
    of per-leaf state), at 2N bytes for N payload bytes (each leaf read, the
    buffer written), a group of one leaf too, since the port's buffer is a
    tensor of its own; and every leaf `buckets_to_tree` casts to another
    dtype (read at the buffer's width, written at the leaf's). Not counted:
    views, the port's scatter (a leaf of the buffer's dtype is a view of it,
    as `BucketedState.to_tree()`'s leaves are), so the bucket-resident step,
    buffer -> buffer, counts 0: no copy is made, where the reference's
    per-call regime scatters every bucket back. `rebucket` and a restore's
    copies into live buffers (`residentize(like=)`) are not conversions of
    a step and are not counted, as in the reference.
    """
    gather_bytes: int = 0    # bytes of tree -> buffer copies
    scatter_bytes: int = 0   # bytes of buffer -> tree casts
    gathers: int = 0
    scatters: int = 0

    @property
    def total_bytes(self) -> int:
        return self.gather_bytes + self.scatter_bytes


_COPY_STATS: Optional[CopyStats] = None


@contextlib.contextmanager
def track_copies():
    """Context manager: count the gather/scatter copies made within (every
    thread's; see `CopyStats`)."""
    global _COPY_STATS
    prev, _COPY_STATS = _COPY_STATS, CopyStats()
    try:
        yield _COPY_STATS
    finally:
        _COPY_STATS = prev


@dataclasses.dataclass(frozen=True)
class BucketedState:
    """A tree whose leaves are the dtype buckets themselves.

    `to_tree()` gives the leaves as views into the buffers (no copy). A
    congruent state (gradients, Adam moments, the ascent gradient) shares
    the layout; its buffers may have another dtype (fp32 moments beside bf16
    parameters).
    """
    buffers: tuple
    layout: BucketLayout

    @classmethod
    def from_tree(cls, tree: Mapping[str, torch.Tensor],
                  layout: Optional[BucketLayout] = None) -> "BucketedState":
        """Gather `tree` into new buffers (one copy, at the boundary)."""
        layout = layout or bucket_layout(tree)
        bufs = []
        for grp in layout.groups:
            first = tree[grp.names[0]]
            buf = torch.empty(grp.size, dtype=first.dtype, device=first.device)
            for n, off, size in zip(grp.names, grp.offsets, grp.sizes):
                buf[off:off + size].copy_(tree[n].detach().reshape(-1))
            bufs.append(buf)
            if _COPY_STATS is not None:
                _COPY_STATS.gathers += 1
                _COPY_STATS.gather_bytes += 2 * grp.size * buf.element_size()
        return cls(buffers=tuple(bufs), layout=layout)

    @classmethod
    def from_module(cls, module: nn.Module) -> "BucketedState":
        """Gather a model's parameters into buffers and make each parameter a
        view into them: the model and the training state share storage, and
        the parameters' own storage is freed."""
        params = dict(module.named_parameters())
        state = cls.from_tree(params)
        empty = empty_modules(module)
        if empty:
            state = cls(state.buffers, dataclasses.replace(state.layout, empty=empty))
        views = state.to_tree()
        with torch.no_grad():
            for name, p in params.items():
                p.data = views[name]
        return state

    def to_tree(self) -> dict[str, torch.Tensor]:
        """Zero-copy views of the leaves, by name, in flatten order."""
        shapes = _shape_of(self.layout)
        out = {}
        for buf, grp in zip(self.buffers, self.layout.groups):
            for n, off, size in zip(grp.names, grp.offsets, grp.sizes):
                out[n] = buf[off:off + size].view(shapes[n])
        return out

    @property
    def device(self) -> torch.device:
        return self.buffers[0].device

    def zeros_like(self, dtype: Optional[torch.dtype] = None) -> "BucketedState":
        return BucketedState(tuple(torch.zeros_like(b, dtype=dtype) for b in self.buffers),
                             self.layout)


def empty_modules(module: nn.Module) -> tuple[str, ...]:
    """Names of a model's parameterless submodules (a non-parametric norm):
    the reference's tree holds an empty dict at each."""
    return tuple(n for n, m in module.named_modules() if n and next(m.parameters(), None) is None)


def is_bucketed(x) -> bool:
    return isinstance(x, BucketedState)


def tree_view(x):
    """The tree view of `x`: `.to_tree()` for a BucketedState, else `x`."""
    return x.to_tree() if is_bucketed(x) else x


def tree_to_buckets(tree: Mapping[str, torch.Tensor], layout: BucketLayout
                    ) -> list[torch.Tensor]:
    """Gather `tree`'s leaves into one new flat buffer per layout group.
    `tree` is congruent with the layout's tree (same names and shapes); its
    dtypes may differ from the layout's if they are uniform within a group
    (fp32 moments beside bf16 parameters)."""
    assert len(tree) == layout.n_leaves, (len(tree), layout.n_leaves)
    for grp in layout.groups:
        dts = {tree[n].dtype for n in grp.names}
        assert len(dts) == 1, f"mixed dtypes within bucket {grp.dtype}: {dts}"
    return list(BucketedState.from_tree(tree, layout).buffers)


def buckets_to_tree(bufs: Sequence[torch.Tensor], layout: BucketLayout,
                    like: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Inverse of tree_to_buckets: each leaf, by name in flatten order, in
    like's shape and dtype; a view of its buffer where the dtype is the
    buffer's, a cast copy otherwise."""
    assert len(like) == layout.n_leaves
    shapes = _shape_of(layout)
    out = {}
    for buf, grp in zip(bufs, layout.groups):
        cast = 0
        for n, off, size in zip(grp.names, grp.offsets, grp.sizes):
            dt = like[n].dtype
            out[n] = buf[off:off + size].view(shapes[n]).to(dt)
            if dt != buf.dtype:
                cast += size * (buf.element_size() + out[n].element_size())
        if cast and _COPY_STATS is not None:
            _COPY_STATS.scatters += 1
            _COPY_STATS.scatter_bytes += cast
    return {n: out[n] for n in layout.names}


def rebucket(state: BucketedState, new_layout: BucketLayout) -> BucketedState:
    """Re-group a BucketedState's buffers directly into `new_layout`, at the
    buffer level: an unchanged grouping passes the buffers through untouched
    (the common elastic-resize case: the layout depends on names, shapes and
    dtypes, not the mesh); otherwise leaves adjacent in their source buffer
    travel as one slice, cast to the target group's dtype, and a target
    group that is one span of one source buffer is that slice, no copy.

    `new_layout` must hold the same leaves and shapes in the same order."""
    if not is_bucketed(state):
        raise TypeError(f"rebucket expects a BucketedState, got {type(state)}; "
                        "use BucketedState.from_tree for a mapping of tensors")
    old = state.layout
    if new_layout.names != old.names or new_layout.shapes != old.shapes:
        raise ValueError(
            "rebucket needs congruent layouts (same leaves/shapes): "
            f"{old.n_leaves} leaves {old.shapes[:3]}... vs "
            f"{new_layout.n_leaves} leaves {new_layout.shapes[:3]}...")
    if new_layout.groups == old.groups:
        return BucketedState(buffers=state.buffers, layout=new_layout)
    src = {}          # leaf name -> (source group index, offset, size)
    for gi, grp in enumerate(old.groups):
        for n, off, size in zip(grp.names, grp.offsets, grp.sizes):
            src[n] = (gi, off, size)
    bufs = []
    for grp in new_layout.groups:
        spans: list[tuple[int, int, int]] = []
        for n in grp.names:
            gi, off, size = src[n]
            if spans and spans[-1][0] == gi and spans[-1][1] + spans[-1][2] == off:
                g0, o0, s0 = spans[-1]
                spans[-1] = (g0, o0, s0 + size)    # coalesce an adjacent run
            else:
                spans.append((gi, off, size))
        dt = getattr(torch, grp.dtype)
        parts = [state.buffers[gi][o:o + s].to(dt) for gi, o, s in spans]
        bufs.append(parts[0] if len(parts) == 1 else torch.cat(parts))
    return BucketedState(buffers=tuple(bufs), layout=new_layout)


def residentize(params: Union[BucketedState, nn.Module, Mapping[str, torch.Tensor], Tree],
                like: Tree = None) -> Tree:
    """The bucket-resident form of `params`: a BucketedState as it is, a
    model's parameters gathered (`from_module`), a mapping of name -> tensor
    gathered (`from_tree`).

    With `like`, a live training state, `params` is a restored state of the
    same structure in portable form (`to_portable`), and every tensor of it
    is copied INTO like's tensors: a BucketedState's buffers through its leaf
    views, per-leaf tensors and device scalars as they are. The model's
    parameters are views into those buffers and the step's gradient views are
    set up against them, so a restore must not allocate new ones. Host
    values (step, rng, flags) are taken from `params`. Returns `like`'s
    structure holding like's tensors.
    """
    if like is not None:
        with torch.no_grad():
            return _copy_into(like, params)
    if is_bucketed(params):
        return params
    if isinstance(params, nn.Module):
        return BucketedState.from_module(params)
    return BucketedState.from_tree(params)


def _copy_into(live: Tree, src: Tree) -> Tree:
    if is_bucketed(live):
        if is_bucketed(src):
            for dst, buf in zip(live.buffers, src.buffers):
                dst.copy_(buf)
        else:
            for name, view in live.to_tree().items():
                view.copy_(src[name])
        return live
    if isinstance(live, torch.Tensor):
        return live.copy_(src)
    if isinstance(live, tuple) and hasattr(live, "_fields"):
        return type(live)(*(_copy_into(a, b) for a, b in zip(live, src)))
    if isinstance(live, (tuple, list)):
        return type(live)(_copy_into(a, b) for a, b in zip(live, src))
    if isinstance(live, Mapping):
        return {k: _copy_into(v, src[k]) for k, v in live.items()}
    return src


def _nodes(tree: Tree) -> list:
    """Every BucketedState and tensor of `tree`, in flatten order."""
    if is_bucketed(tree) or isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [n for k in sorted(tree) for n in _nodes(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [n for t in tree for n in _nodes(t)]
    return []


def is_resident(tree: Tree) -> bool:
    """True when any node of `tree` is a BucketedState."""
    return any(is_bucketed(n) for n in _nodes(tree))


def layout_stamp(tree: Tree) -> list[dict]:
    """JSON-able record of every resident node's bucket layout (checkpoint
    manifests stamp it beside the per-leaf arrays), the reference's format."""
    return [{"n_leaves": n.layout.n_leaves,
             "groups": [{"dtype": g.dtype, "size": g.size} for g in n.layout.groups]}
            for n in _nodes(tree) if is_bucketed(n)]


def to_portable(tree: Tree) -> Tree:
    """Replace every BucketedState node (inside NamedTuples, tuples, lists and
    dicts) with its mapping of leaf name -> tensor: the per-leaf form, the
    shape of a state that was never resident."""
    if is_bucketed(tree):
        return tree.to_tree()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_portable(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_portable(x) for x in tree)
    if isinstance(tree, Mapping):
        return {k: to_portable(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# Fused-path switch
# ---------------------------------------------------------------------------

_FUSED_DEFAULT: Optional[bool] = None


def set_fused_default(enabled: Optional[bool]) -> None:
    """Process-wide default of the fused weight-space path (a test hook;
    None restores the port's own)."""
    global _FUSED_DEFAULT
    _FUSED_DEFAULT = enabled


def fused_path_enabled(override: Optional[bool] = None) -> bool:
    """Whether a weight-space call on per-leaf state takes the flat-buffer
    kernels: the override (`MethodConfig.fused_update`, `FusedSpec.enabled`)
    > the process default (`set_fused_default`) > the port's default, on
    (the kernels on the card, their plain versions on the CPU; the
    reference's is on for a TPU only). Off is the reference's per-leaf
    composition. Bucket-resident state runs the kernels whatever this says,
    and the executors pin the override when they resolve `fused_update`,
    so the process default reaches only a call left at None."""
    if override is not None:
        return bool(override)
    if _FUSED_DEFAULT is not None:
        return _FUSED_DEFAULT
    return True


# ---------------------------------------------------------------------------
# Bucketed weight-space primitives (thin sums over the per-bucket kernels)
# ---------------------------------------------------------------------------

def group_buffers(tree: Union[BucketedState, Mapping[str, torch.Tensor]],
                  layout: Optional[BucketLayout] = None
                  ) -> tuple[list[torch.Tensor], BucketLayout]:
    """`tree` as per-group flat buffers: free for a BucketedState (they ARE
    its leaves), one gather for a mapping of tensors."""
    if is_bucketed(tree):
        return list(tree.buffers), tree.layout
    state = BucketedState.from_tree(tree, layout)
    return list(state.buffers), state.layout


def bucketed_sq_norm(tree, layout: Optional[BucketLayout] = None, *,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Global squared L2 norm via one single-pass kernel per bucket."""
    bufs, _ = group_buffers(tree, layout)
    return torch.sum(torch.stack([ops.sq_norm(b, impl=impl) for b in bufs]))


def bucketed_axpy(alpha, x, y, *, out: Optional[BucketedState] = None,
                  layout: Optional[BucketLayout] = None,
                  impl: Optional[str] = None):
    """alpha * x + y on buckets (the perturbation axpy), dtypes of `y` kept.

    Resident in, resident out: for a BucketedState `y` the result is a
    BucketedState, written into `out` when given (a preallocated buffer the
    caller reuses every step); a mapping `y` gives a mapping.
    """
    yb, layout = group_buffers(y, layout)
    xb, _ = group_buffers(x, layout)
    ob = out.buffers if out is not None else [None] * len(yb)
    res = BucketedState(tuple(ops.fused_axpy(alpha, xi, yi, out=oi, impl=impl)
                              for xi, yi, oi in zip(xb, yb, ob)), layout)
    return res if is_bucketed(y) else res.to_tree()


def bucketed_sam_perturb(w, g, rho, sq_norm, *, out: Optional[BucketedState] = None,
                         layout: Optional[BucketLayout] = None, impl: Optional[str] = None):
    """w + rho * g / (sqrt(sq_norm) + eps) on buckets, w's dtypes kept: one
    `sam_perturb` kernel per bucket. Resident in, resident out (into `out`
    when given), as `bucketed_axpy`."""
    wb, layout = group_buffers(w, layout)
    gb, _ = group_buffers(g, layout)
    ob = out.buffers if out is not None else [None] * len(wb)
    res = BucketedState(tuple(ops.sam_perturb(wi, gi, rho, sq_norm, out=oi, impl=impl)
                              for wi, gi, oi in zip(wb, gb, ob)), layout)
    return res if is_bucketed(w) else res.to_tree()


def bucketed_dot_norms(a, b, *, layout: Optional[BucketLayout] = None,
                       impl: Optional[str] = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(<a,b>, ||a||^2, ||b||^2) in one pass over (a, b) per bucket: the
    AsyncSAM ascent-state refresh (the cosine metric and the carried norm)."""
    ab, layout = group_buffers(a, layout)
    bb, _ = group_buffers(b, layout)
    parts = [ops.fused_dot_norms(ai, bi, impl=impl) for ai, bi in zip(ab, bb)]
    return tuple(torch.sum(torch.stack([p[k] for p in parts])) for k in range(3))


# ---------------------------------------------------------------------------
# The host edge: the lane hand-off and the wire carry the reference's nested
# tree of numpy arrays (per-block leaves stacked), flattened as jax flattens
# it (dict keys sorted, lists and tuples in order, None holding no leaf)
# ---------------------------------------------------------------------------

def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array the caller owns (copied off the device, or
    off a CPU tensor the step may overwrite); bf16 as ml_dtypes' bfloat16,
    which the wire's dtype names need."""
    return _numpy_view(t.detach().to("cpu", copy=True))


def host_flatten(tree) -> tuple[list, Any]:
    """(leaves, treedef) of a nested host tree, in jax's flatten order. The
    treedef is a hashable skeleton: "*" for a leaf, None, ("dict", keys,
    children), ("list" | "tuple", children)."""
    leaves: list = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, Mapping):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return ("tuple" if isinstance(node, tuple) else "list",
                    tuple(walk(x) for x in node))
        leaves.append(node)
        return "*"

    return leaves, walk(tree)


def host_unflatten(treedef, leaves: Sequence):
    """Inverse of `host_flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node == "*":
            return next(it)
        if node[0] == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        out = [build(c) for c in node[1]]
        return tuple(out) if node[0] == "tuple" else out

    return build(treedef)


@dataclasses.dataclass(frozen=True)
class HostGroup:
    """One dtype bucket of a host tree (`repro.utils.buckets.BucketGroup`)."""
    dtype: str
    leaf_indices: tuple[int, ...]   # indices into the flattened leaf list
    offsets: tuple[int, ...]
    sizes: tuple[int, ...]
    size: int


@dataclasses.dataclass(frozen=True)
class HostLayout:
    """The reference's `BucketLayout` of a host tree: the same grouping (by
    dtype name, sorted) and order, so a host bucket of the reference's tree
    equals the port's device bucket of the same parameters element for
    element."""
    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    groups: tuple[HostGroup, ...]
    n_leaves: int


_HOST_LAYOUT_CACHE: dict = {}


def _dtype_str(dtype) -> str:
    return dtype_name(dtype) if isinstance(dtype, torch.dtype) else np.dtype(dtype).name


def host_layout(tree) -> HostLayout:
    """Layout for a host tree (numpy arrays or tensors, anything with .shape
    and .dtype), cached on (treedef, shapes, dtypes)."""
    leaves, treedef = host_flatten(tree)
    key = (treedef, tuple((tuple(x.shape), _dtype_str(x.dtype)) for x in leaves))
    hit = _HOST_LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    by_dtype: dict[str, list[int]] = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(_dtype_str(x.dtype), []).append(i)
    groups = []
    for dname in sorted(by_dtype):
        idx = by_dtype[dname]
        sizes = tuple(math.prod(leaves[i].shape) for i in idx)
        offsets = tuple(sum(sizes[:j]) for j in range(len(sizes)))
        groups.append(HostGroup(dtype=dname, leaf_indices=tuple(idx), offsets=offsets,
                                sizes=sizes, size=sum(sizes)))
    layout = HostLayout(treedef=treedef, shapes=tuple(tuple(x.shape) for x in leaves),
                        groups=tuple(groups), n_leaves=len(leaves))
    _HOST_LAYOUT_CACHE[key] = layout
    return layout


def host_portable(params) -> Any:
    """The lane / wire form of `params`: the reference's nested tree of numpy
    arrays the caller owns. A BucketedState's buffers cross to the host whole
    (one copy per dtype bucket) and are cut there, stacked block leaves being
    views of the host bucket; a mapping of name -> tensor is stacked and
    copied leaf by leaf; a host tree (numpy leaves) passes as it is."""
    from repro_torch.models import convert
    if is_bucketed(params):
        host = BucketedState(tuple(b.detach().to("cpu", copy=True) for b in params.buffers),
                             params.layout)
        return convert.to_reference(host.to_tree(), leaf=_numpy_view,
                                    empty=params.layout.empty)
    if isinstance(params, Mapping) and all(isinstance(v, torch.Tensor) for v in params.values()):
        return convert.to_reference(params, leaf=host_array)
    return params


def _numpy_view(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy without a copy (bf16 as ml_dtypes' bfloat16)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def host_tree_to_buckets(tree, layout: HostLayout, dtype=None) -> list[np.ndarray]:
    """Concatenate a host tree's leaves per layout group (numpy, no device).
    `dtype` (e.g. float32) casts every bucket; None keeps each group's
    dtype."""
    leaves, _ = host_flatten(tree)
    assert len(leaves) == layout.n_leaves, (len(leaves), layout.n_leaves)
    out = []
    for grp in layout.groups:
        parts = [np.asarray(leaves[i]).reshape(-1) for i in grp.leaf_indices]
        buf = parts[0] if len(parts) == 1 else np.concatenate(parts)
        if dtype is not None:
            buf = buf.astype(dtype, copy=False)
        out.append(np.ascontiguousarray(buf))
    return out


def host_buckets_to_tree(bufs: Sequence, layout: HostLayout, leaf_dtypes=None):
    """Inverse of `host_tree_to_buckets`: cut flat host buffers into the
    layout's tree (views where the dtype already matches); `leaf_dtypes`
    (flatten order) casts each leaf back to its own dtype."""
    leaves: list = [None] * layout.n_leaves
    for buf, grp in zip(bufs, layout.groups):
        buf = np.asarray(buf)
        for i, off, size in zip(grp.leaf_indices, grp.offsets, grp.sizes):
            leaf = buf[off:off + size].reshape(layout.shapes[i])
            if leaf_dtypes is not None:
                leaf = leaf.astype(leaf_dtypes[i], copy=False)
            leaves[i] = leaf
    return host_unflatten(layout.treedef, leaves)
