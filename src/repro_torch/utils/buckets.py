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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Union

import torch
from torch import nn

from repro_torch.kernels import ops

Tree = Any


def dtype_name(dtype: torch.dtype) -> str:
    """"float32", "bfloat16", ...: the names jnp.dtype gives."""
    return str(dtype).removeprefix("torch.")


def reference_path(name: str) -> tuple[tuple[str, ...], Optional[int]]:
    """A port leaf name as (its path in the reference's tree, its block index
    or None): the reference stacks the blocks on a leading axis, so
    "blocks.3.attn.wq" is block 3 of the reference's leaf blocks/attn/wq."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "blocks" and parts[1].isdigit():
        return ("blocks", *parts[2:]), int(parts[1])
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
        return cls(buffers=tuple(bufs), layout=layout)

    @classmethod
    def from_module(cls, module: nn.Module) -> "BucketedState":
        """Gather a model's parameters into buffers and make each parameter a
        view into them: the model and the training state share storage, and
        the parameters' own storage is freed."""
        params = dict(module.named_parameters())
        state = cls.from_tree(params)
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


def is_bucketed(x) -> bool:
    return isinstance(x, BucketedState)


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
