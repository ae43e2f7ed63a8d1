"""Carry parameters across from the JAX package.

`params_from_jax` turns the reference's parameter pytree, given as nested
dicts of numpy arrays (`jax.tree.map(np.asarray, params)`), into the port's
`state_dict`. The reference stacks the blocks on a leading L axis; the port
keeps one module per block, so every leaf under "blocks" is split along that
axis. Weights keep the reference's (d_in, d_out) orientation, which is the
port's too. bf16 leaves cross as uint16 views of their bits (or as the
`bfloat16` dtype that `ml_dtypes` gives numpy), since numpy has no bf16.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    t = torch.from_numpy(a.copy())
    return t.view(torch.bfloat16) if a.dtype == np.uint16 else t


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for name, leaf in tree.items():
        path = f"{prefix}{name}"
        if isinstance(leaf, Mapping):
            out.update(_flatten(leaf, path + "."))
        else:
            out[path] = np.asarray(leaf)
    return out


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Reference pytree (nested dicts of numpy arrays) -> port state_dict."""
    state = {}
    for path, leaf in _flatten(tree).items():
        if path.startswith("blocks."):
            rest = path[len("blocks."):]
            for i in range(leaf.shape[0]):
                state[f"blocks.{i}.{rest}"] = _to_tensor(leaf[i])
        else:
            state[path] = _to_tensor(leaf)
    return state
