"""Tree helpers on dicts of tensors (counterpart of `repro.utils.trees`).

A tree here is a tensor, a mapping of name -> tree, a tuple, NamedTuple or
list of trees, or a `buckets.BucketedState`, whose leaves are its flat
buffers (as a registered pytree node's are in the reference). Mappings are
walked in sorted key order, as `jax.tree.flatten` walks dicts. A leaf's path
(`tree_paths`) is the reference's: keys, field names and indices joined by
"/", where a port parameter name ("blocks.3.attn.wq") is its path in the
reference's tree ("blocks/attn/wq": the reference stacks the blocks on a
leading axis). A leaf of a tree is any tensor the tree holds, so the
leafwise helpers take NamedTuples and BucketedStates alike.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch

from repro_torch.utils import buckets, distributed

Tree = Any


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, buckets.BucketedState):
        return list(tree.buffers)
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_map(f: Callable[..., torch.Tensor], tree: Tree, *rest: Tree) -> Tree:
    """`f` on every leaf (with the matching leaves of `rest`, trees of the
    same structure); the result has the tree's structure (a BucketedState
    keeps its layout)."""
    return tree_map_with_path(lambda _, *leaves: f(*leaves), tree, *rest)


def _key_path(key) -> str:
    """A mapping key as a path: a port parameter name ("blocks.3.attn.wq")
    becomes its path in the reference's tree ("blocks/attn/wq")."""
    return "/".join(buckets.reference_path(str(key))[0])


def tree_map_with_path(f: Callable[..., torch.Tensor], tree: Tree, *rest: Tree,
                       _prefix: str = "") -> Tree:
    """`f(path, leaf, *rest_leaves)` on every leaf (see the module docstring
    for paths)."""
    def sub(name: str) -> str:
        return f"{_prefix}/{name}" if _prefix else name

    if isinstance(tree, torch.Tensor):
        return f(_prefix, tree, *rest)
    if isinstance(tree, buckets.BucketedState):
        return buckets.BucketedState(
            tuple(f(sub(str(i)), *bs)
                  for i, bs in enumerate(zip(tree.buffers, *(r.buffers for r in rest)))),
            tree.layout)
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(f, v, *(r[k] for r in rest), _prefix=sub(_key_path(k)))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(f, v, *(getattr(r, name) for r in rest),
                                               _prefix=sub(name))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(f, v, *(r[i] for r in rest), _prefix=sub(str(i)))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_paths(tree: Tree) -> list[str]:
    """The path of every leaf, in `tree_leaves` order."""
    paths: dict[int, str] = {}

    def note(path: str, x: torch.Tensor) -> torch.Tensor:
        paths[id(x)] = path
        return x

    tree_map_with_path(note, tree)
    return [paths[id(x)] for x in tree_leaves(tree)]


def tree_copy_(dst: Tree, src: Tree) -> Tree:
    """Copy every leaf of `src` into the matching leaf of `dst`, in place;
    returns `dst`. How a step writes its new values into the state's
    tensors, which the model and the buffers' views keep reading."""
    with torch.no_grad():
        tree_map(lambda d, s: d.copy_(s), dst, src)
    return dst


def tree_zeros_like(tree: Tree, dtype=None) -> Tree:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype), tree)


def tree_ones_like(tree: Tree) -> Tree:
    return tree_map(torch.ones_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x: Tree, y: Tree) -> Tree:
    """alpha * x + y, leafwise (the SAM perturbation primitive)."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_where(pred, a: Tree, b: Tree) -> Tree:
    """Leafwise select; `pred` is a scalar boolean (a bool or a 0-d tensor)."""
    return tree_map(lambda x, y: torch.where(torch.as_tensor(pred, device=x.device), x, y),
                    a, b)


def _in_leaf_order(tree: Tree, values: list) -> Tree:
    """`tree` with its i-th leaf in `tree_leaves` order replaced by
    values[i] (`tree_map` walks a mapping in its own order)."""
    by_leaf: dict[int, list] = {}
    for x, v in zip(tree_leaves(tree), values):
        by_leaf.setdefault(id(x), []).append(v)
    return tree_map(lambda x: by_leaf[id(x)].pop(0), tree)


def tree_random_like(gen: torch.Generator, tree: Tree, std: float = 1.0) -> Tree:
    """Gaussian tree matching `tree`'s structure, shapes and dtypes (ESAM
    masks, the loss landscape's directions, tests): each leaf drawn in fp32
    from `gen`, in `tree_leaves` order, on gen's device, then cast to the
    leaf's dtype, moved to its device and scaled by `std`. The reference
    takes a JAX key and splits it per leaf; the draws differ from its, and
    the same generator state gives the same tree."""
    return _in_leaf_order(tree, [
        torch.randn(tuple(x.shape), generator=gen, dtype=torch.float32, device=gen.device)
        .to(device=x.device, dtype=x.dtype) * std for x in tree_leaves(tree)])


def tree_flatten_to_vector(tree: Tree) -> torch.Tensor:
    """Concatenate all leaves, in `tree_leaves` order, into one fp32 vector
    (compression, landscape viz)."""
    return torch.cat([x.float().reshape(-1) for x in tree_leaves(tree)])


def tree_unflatten_from_vector(vec: torch.Tensor, like: Tree) -> Tree:
    """Inverse of tree_flatten_to_vector against a template tree: each leaf
    is its span of `vec` in like's shape, cast to like's dtype (a view of
    `vec` where the dtype is already vec's)."""
    spans, off = [], 0
    for x in tree_leaves(like):
        n = math.prod(x.shape)
        spans.append(vec[off:off + n].reshape(x.shape).to(x.dtype))
        off += n
    return _in_leaf_order(like, spans)


def tree_cast(tree: Tree, dtype) -> Tree:
    """Leaves cast to `dtype` (a leaf already of that dtype is kept as is)."""
    if dtype is None:
        return tree
    return tree_map(lambda x: x.to(dtype), tree)


def tree_sq_norm(tree: Tree) -> torch.Tensor:
    """Global squared L2 norm, accumulated in fp32. On sharded leaves
    (DTensors) each rank sums its shards and one all-reduce over the mesh
    adds them (`distributed.sharded_sum`): a plain 0-d tensor, the same bits
    on every rank."""
    xs = tree_leaves(tree)
    if any(map(distributed.is_dtensor, xs)):
        return distributed.sharded_sum(xs, lambda x: torch.sum(torch.square(x.float())))
    leaves = [torch.sum(torch.square(x.float())) for x in xs]
    return torch.sum(torch.stack(leaves)) if leaves else torch.zeros(())


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(tree))


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Global inner product <a, b> in fp32 (sharded leaves as `tree_sq_norm`)."""
    xs, ys = tree_leaves(a), tree_leaves(b)
    if any(map(distributed.is_dtensor, xs)):
        return distributed.sharded_sum(xs, lambda x, y: torch.sum(x.float() * y.float()), ys)
    parts = [torch.sum(x.float() * y.float()) for x, y in zip(xs, ys)]
    return torch.sum(torch.stack(parts)) if parts else torch.zeros(())


def tree_cosine_similarity(a: Tree, b: Tree, eps: float = 1e-12) -> torch.Tensor:
    """Cosine similarity between two gradient trees (paper Fig. 1 metric)."""
    return tree_dot(a, b) / (global_norm(a) * global_norm(b) + eps)


def tree_size(tree: Tree) -> int:
    """Total number of elements."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def tree_bytes(tree: Tree) -> int:
    """Total bytes of the leaves (a DTensor at its global shape)."""
    return sum(math.prod(x.shape) * x.dtype.itemsize for x in tree_leaves(tree))
