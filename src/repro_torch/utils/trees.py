"""Tree helpers on dicts of tensors (counterpart of `repro.utils.trees`).

A tree here is a tensor, a mapping of name -> tree, a tuple or list of
trees, or a `buckets.BucketedState`, whose leaves are its flat buffers (as a
registered pytree node's are in the reference). Mappings are walked in
sorted key order, as `jax.tree.flatten` walks dicts. Only the helpers the
training step uses are ported.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch

from repro_torch.utils import buckets

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


def tree_map(f: Callable[[torch.Tensor], torch.Tensor], tree: Tree) -> Tree:
    """`f` on every leaf; the result has the tree's structure (a
    BucketedState keeps its layout)."""
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, buckets.BucketedState):
        return buckets.BucketedState(tuple(f(b) for b in tree.buffers), tree.layout)
    if isinstance(tree, Mapping):
        return {k: tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, t) for t in tree)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_zeros_like(tree: Tree, dtype=None) -> Tree:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype), tree)


def tree_cast(tree: Tree, dtype) -> Tree:
    """Leaves cast to `dtype` (a leaf already of that dtype is kept as is)."""
    if dtype is None:
        return tree
    return tree_map(lambda x: x.to(dtype), tree)


def tree_sq_norm(tree: Tree) -> torch.Tensor:
    """Global squared L2 norm, accumulated in fp32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sum(torch.stack(leaves)) if leaves else torch.zeros(())


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(tree))


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Global inner product <a, b> in fp32."""
    parts = [torch.sum(x.float() * y.float()) for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return torch.sum(torch.stack(parts)) if parts else torch.zeros(())


def tree_cosine_similarity(a: Tree, b: Tree, eps: float = 1e-12) -> torch.Tensor:
    """Cosine similarity between two gradient trees (paper Fig. 1 metric)."""
    return tree_dot(a, b) / (global_norm(a) * global_norm(b) + eps)


def tree_size(tree: Tree) -> int:
    """Total number of elements."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))
