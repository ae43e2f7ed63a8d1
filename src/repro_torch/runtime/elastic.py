"""Elastic scaling: move a training state between meshes of different size
(counterpart of `repro.runtime.elastic`).

A checkpoint written on one mesh restores onto another because the manager
stores full arrays; this module is the in-memory equivalent:
`reshard_state(state, cfg, new_mesh)` re-places every leaf against the
sharding rules evaluated on the new mesh, rank to rank through collectives,
never through a file. For each leaf, in the tree's order:
  * a sharded leaf (a DTensor) is gathered to its full tensor on the ranks of
    its mesh (an all-gather), and when that mesh does not span the world it
    is broadcast from rank 0 (every mesh holds rank 0: meshes take a prefix
    of the world) to every rank;
  * a plain tensor leaf (a scalar of the state, or a meshless state's leaf)
    and the host values (step, flags) are broadcast from rank 0 as well, so a
    rank that sat outside the last mesh comes back in step;
  * on the new mesh each rank keeps its shard of the full tensor; a rank
    outside it holds an empty one.
Peak memory is one full leaf at a time. The global batch is preserved across
a resize; only the per-rank slice changes.

Bucket-resident state (`utils.buckets.BucketedState`) re-places onto an
unsharded target directly (the buffers move wholesale; the layout is
mesh-independent); a sharded target raises, as in the reference: flattening
a model-sharded leaf into a global bucket would gather it whole, and
per-shard bucketing is the reference's own follow-on.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import torch

from repro_torch.launch.mesh import Mesh, _device_type, _live_mesh
from repro_torch.launch.sharding import map_specs, state_spec_tree, to_placements
from repro_torch.utils import buckets, distributed

Tree = Any


class LeafSharding:
    """Where one leaf lives: a mesh and the leaf's placements on it (the
    counterpart of a NamedSharding)."""

    __slots__ = ("mesh", "placements")

    def __init__(self, mesh: Mesh, placements: tuple):
        self.mesh, self.placements = mesh, placements

    def __repr__(self) -> str:
        return f"LeafSharding({self.mesh!r}, {self.placements})"


def make_sized_mesh(devices: int, model_axis: int = 1,
                    device: Union[str, torch.device, None] = None) -> Mesh:
    """A (data, model) mesh over the first `devices` ranks of the world.

    Unlike `launch.mesh.make_host_mesh` this does not claim every rank: a
    shrink builds the survivor mesh over a prefix of the world, a grow takes
    the prefix back up. The deterministic rank order keeps scripted chaos
    schedules reproducible. `device` as `make_host_mesh`'s (with a process
    group, its backend's device by default).
    """
    n = distributed.world_size()
    if devices > n:
        raise ValueError(f"mesh of {devices} devices requested but only "
                         f"{n} are attached")
    if devices % model_axis:
        raise ValueError(f"{devices} devices do not divide model_axis="
                         f"{model_axis}")
    dtype = _device_type(device if device is not None
                         else distributed.backend_device_type())
    if not distributed.is_initialized():
        return Mesh(("data", "model"), (1, 1), dtype)
    return _live_mesh((devices // model_axis, model_axis), ("data", "model"), dtype)


def state_shardings(state_like: Tree, cfg, mesh: Mesh) -> Tree:
    """A LeafSharding for every leaf of a TrainState(-like) tree on `mesh`."""
    return map_specs(lambda spec: LeafSharding(mesh, to_placements(spec, mesh)),
                     state_spec_tree(state_like, cfg, mesh))


def full_leaf(x: torch.Tensor, like_everywhere: bool) -> torch.Tensor:
    """The full value of leaf `x` on this rank: gathered over its mesh, and
    broadcast from rank 0 when `like_everywhere` (the ranks outside its mesh
    need it too)."""
    if not distributed.is_dtensor(x):
        if distributed.world_size() > 1:
            x = distributed.broadcast_tensor(x.detach().clone())
        return x
    full = distributed.gather(x)
    if like_everywhere and distributed.world_size() > 1:
        if full.numel() == 0 and x.numel() != 0:
            full = torch.empty(x.shape, dtype=x.dtype, device=full.device)
        full = distributed.broadcast_tensor(full)
    return full


def place_leaf(full: torch.Tensor, mesh: Optional[Mesh], placements) -> torch.Tensor:
    """`full` on `mesh`: a DTensor when the mesh is sharded, else the plain
    tensor on the mesh's device (this process's own with no mesh). A 0-d
    leaf (a norm, a step counter) stays a plain tensor, the same on every
    rank, as the sharded step's reductions give it."""
    if mesh is not None and mesh.sharded and full.dim():
        return distributed.place(full, mesh.device_mesh, placements)
    device = mesh.device if mesh is not None else full.device
    return full.to(device).clone()


def _spans_world(x) -> bool:
    mesh = x.device_mesh
    return mesh.mesh.numel() == distributed.world_size()


def reshard_state(state: Tree, cfg, new_mesh: Optional[Mesh]) -> Tree:
    """Re-place every leaf of `state` onto `new_mesh` under the arch rules
    (None: each rank holds the whole state, meshless)."""
    if buckets.is_resident(state):
        if new_mesh is not None and new_mesh.size > 1:
            raise ValueError(
                "cannot reshard bucket-resident state onto a sharded mesh "
                f"(size {new_mesh.size}): flattened buckets would all-gather "
                "model-sharded leaves. View it out with buckets.to_portable "
                "first (and residentize after), or keep the target unsharded "
                "— per-shard bucketing is the reference's follow-on.")
        if new_mesh is None:
            return state
        # unsharded target: buffers move wholesale (one transfer per bucket)
        return _map_tensors(lambda path, x: x.to(new_mesh.device), state)
    placements = (to_placements(state_spec_tree(state, cfg, new_mesh), new_mesh)
                  if new_mesh is not None and new_mesh.sharded else None)

    def move(x, pl):
        if isinstance(x, torch.Tensor):
            everywhere = distributed.is_dtensor(x) and not _spans_world(x)
            with torch.no_grad():
                return place_leaf(full_leaf(x.detach(), everywhere), new_mesh, pl)
        return distributed.broadcast_object(x)   # host values, rank 0's

    return _zip_map(move, state, placements)


def _zip_map(f, tree, pl):
    """f(leaf, placements) over `tree` with the congruent placements tree
    (None: no placements anywhere)."""
    if isinstance(tree, torch.Tensor) or not isinstance(
            tree, (Mapping, tuple, list)):
        return f(tree, pl)
    if isinstance(tree, Mapping):
        return {k: _zip_map(f, v, None if pl is None else pl[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(f, v, None if pl is None else p)
                            for v, p in zip(tree, pl if pl is not None else [None] * len(tree))))
    return type(tree)(_zip_map(f, v, None if pl is None else p)
                      for v, p in zip(tree, pl if pl is not None else [None] * len(tree)))


def _map_tensors(f, tree, prefix: str = ""):
    if buckets.is_bucketed(tree):
        return buckets.BucketedState(tuple(f(prefix, b) for b in tree.buffers), tree.layout)
    if isinstance(tree, torch.Tensor):
        return f(prefix, tree)
    if isinstance(tree, Mapping):
        return {k: _map_tensors(f, v, prefix) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(f, v, prefix) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(f, v, prefix) for v in tree)
    return tree


