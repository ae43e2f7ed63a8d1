"""The port's parameter names against the reference's parameter tree.

The reference keeps its parameters as a nested tree whose per-block leaves
are stacked on a leading L axis ("blocks" -> "attn" -> "wq" of shape
(L, d, d)); the port keeps one module per block, named
"blocks.<i>.attn.wq". Every place where the two meet maps one onto the other
here:
* `reference_groups` orders a mapping of port names as the reference
  flattens its tree, grouping the block leaves of one path (the checkpoint
  writes each group as one leaf);
* `stack_blocks` makes one (L, ...) leaf of a group's block leaves, a view
  when they lie end to end in one buffer (a bucket's do);
* `to_reference` builds the reference's nested tree from a mapping of port
  names (the lane hand-off and the wire carry that tree), and
  `from_reference` cuts a nested tree back into port names, block leaves as
  views of the stacked leaf (`blocks`, `enc_blocks`, `dec_blocks`; a moe
  model's `dense_blocks` the reference keeps as a list, one subtree a layer);
* `params_from_jax` turns the reference's parameter tree, given as nested
  dicts of numpy arrays (`jax.tree.map(np.asarray, params)`), into the port's
  `state_dict`.
Weights keep the reference's (d_in, d_out) orientation, which is the port's
too. bf16 leaves cross as uint16 views of their bits (or as the `bfloat16`
dtype that `ml_dtypes` gives numpy), since numpy has no bf16.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils import buckets


def reference_groups(names) -> Iterator[tuple[str, list, bool]]:
    """(path, keys, stacked) per leaf of the reference's tree, in its flatten
    order: a port name is its path in the reference's tree
    (`buckets.reference_path`), and the block leaves of one name form one
    stacked leaf (keys in block order)."""
    groups: dict[tuple, dict] = {}
    for key in names:
        path, block = buckets.reference_path(str(key))
        groups.setdefault(path, {})[block] = key
    for path in sorted(groups):
        keys = groups[path]
        if None in keys:
            yield "/".join(path), [keys[None]], False
            continue
        if sorted(keys) != list(range(len(keys))):
            raise ValueError(f"blocks of {'/'.join(path)} are not 0..L-1: {sorted(keys)}")
        yield "/".join(path), [keys[i] for i in range(len(keys))], True


def stack_blocks(leaves: list[torch.Tensor]) -> torch.Tensor:
    """The block leaves as one (L, ...) tensor: a view when they lie end to
    end in one buffer (a bucket's do), else a stacked copy."""
    first = leaves[0]
    nbytes = first.numel() * first.element_size()
    if all(t.is_contiguous() and t.untyped_storage().data_ptr()
           == first.untyped_storage().data_ptr()
           and t.data_ptr() == first.data_ptr() + i * nbytes for i, t in enumerate(leaves)):
        return torch.empty(0, dtype=first.dtype, device=first.device).set_(
            first.untyped_storage(), first.storage_offset(), (len(leaves), *first.shape))
    return torch.stack(leaves)


def to_reference(mapping: Mapping[str, torch.Tensor],
                 leaf: Optional[Callable[[torch.Tensor], Any]] = None,
                 empty: Sequence[str] = ()) -> dict:
    """The reference's nested tree (dicts with sorted keys, as `jax.tree`
    rebuilds them) from a mapping of port names to tensors, each stacked
    block leaf a view where `stack_blocks` can make one; `leaf` maps every
    leaf of the result (e.g. to numpy). `empty` names parameterless modules
    (`BucketLayout.empty`), an empty dict in the reference's tree."""
    tree: dict = {}
    for path, keys, stacked in reference_groups(mapping):
        val = stack_blocks([mapping[k] for k in keys]) if stacked else mapping[keys[0]]
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf(val) if leaf is not None else val
    for name in empty:
        node = tree
        for p in buckets.reference_path(name)[0]:
            node = node.setdefault(p, {})
    return _sorted(tree)


def _sorted(tree: dict):
    """Keys sorted at every level; a node keyed 0..n-1 (`dense_blocks`)
    becomes the list the reference keeps there."""
    out = {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def from_reference(tree, prefix: str = "") -> dict:
    """Port name -> leaf of a nested reference tree (numpy arrays or
    tensors); a leaf under a stacked list (`buckets.STACKED`) is cut along
    its leading axis into views, one per block; a list's items are named by
    their index."""
    out = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for name, leaf in items:
        path = f"{prefix}{name}"
        if isinstance(leaf, (Mapping, list, tuple)):
            out.update(from_reference(leaf, path + "."))
            continue
        top, _, rest = path.partition(".")
        if top in buckets.STACKED and rest:
            for i in range(leaf.shape[0]):
                out[f"{top}.{i}.{rest}"] = leaf[i]
        else:
            out[path] = leaf
    return out


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    t = torch.from_numpy(a.copy())
    return t.view(torch.bfloat16) if a.dtype == np.uint16 else t


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Reference pytree (nested dicts of numpy arrays) -> port state_dict."""
    return {name: _to_tensor(np.asarray(leaf)) for name, leaf in from_reference(tree).items()}
