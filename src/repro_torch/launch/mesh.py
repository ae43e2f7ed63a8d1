"""Meshes (counterpart of `repro.launch.mesh`).

The port's `Mesh` reads as `jax.sharding.Mesh` does where the sharding rules
look (`shape[axis]`, `axis_names`, `size`), so the rules run on it, or on
any object with those two attributes, unchanged. A mesh is live when it
spans ranks of the process group: it then carries the `DeviceMesh` over
them (its dims named as the axes) and the ranks, in grid order. A mesh with
more devices than the world has ranks is abstract: the rules and the dry
run read it, nothing is placed on it.

The world is the default process group: gloo on the CPU, NCCL on the card,
one rank per device. `init_from_env` starts it as `torchrun` (`python -m
torch.distributed.run`) sets it up; without a group the world is this
process, and `make_host_mesh` gives a 1-device mesh on its device, as the
reference's host mesh is on one chip. Every live mesh is built on every rank
of the world in the same order (its process groups are made collectively),
and cached, so rebuilding one costs nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from repro_torch.utils import distributed

_LIVE: dict[tuple, "Mesh"] = {}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device_type: str = "cpu"
    ranks: Optional[tuple[int, ...]] = None   # world ranks in grid order (live)
    device_mesh: object = None                # the DeviceMesh over them (live)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def live(self) -> bool:
        return self.device_mesh is not None

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    @property
    def is_member(self) -> bool:
        """Whether this rank holds a part of the mesh (a 1-device mesh with no
        process group is this process's own)."""
        if self.device_mesh is None:
            return self.ranks is None or distributed.rank() in self.ranks
        return self.device_mesh.get_coordinate() is not None

    @property
    def sharded(self) -> bool:
        """Whether state on this mesh is placed as DTensors: a live mesh in a
        world of more than one rank."""
        return self.live and distributed.world_size() > 1

    def __repr__(self) -> str:
        kind = f"live on ranks {list(self.ranks)}" if self.live else "abstract"
        return f"Mesh({self.shape}, {self.device_type}, {kind})"


def _live_mesh(axis_sizes: tuple[int, ...], axis_names: tuple[str, ...],
               device_type: str) -> Mesh:
    """The mesh over the first prod(axis_sizes) ranks of the world, built
    (collectively, on every rank) at first use and cached."""
    key = (axis_sizes, axis_names, device_type)
    if key in _LIVE:
        return _LIVE[key]
    from torch.distributed.device_mesh import DeviceMesh

    n, world = math.prod(axis_sizes), distributed.world_size()
    ranks = tuple(range(n))
    dm = DeviceMesh(device_type, torch.tensor(ranks).reshape(axis_sizes),
                    mesh_dim_names=axis_names)
    flat = dist.group.WORLD if n == world else dist.new_group(list(ranks))
    # one data-parallel group per index along "model": the ranks that hold
    # the same model shard (every other axis is data-parallel)
    grid = torch.tensor(ranks).reshape(axis_sizes)
    m = axis_names.index("model") if "model" in axis_names else None
    dp_groups = {}
    for j in range(axis_sizes[m] if m is not None else 1):
        members = (grid.select(m, j) if m is not None else grid).reshape(-1).tolist()
        dp_groups[j] = (dist.group.WORLD if len(members) == world
                        else dist.new_group(members))
    # one model group per dp index: the ranks along "model" that share their
    # rows (tensor-parallel compute reduces over it); none for a 1-wide axis
    model_groups = {}
    if m is not None and axis_sizes[m] > 1:
        for j, members in enumerate(grid.movedim(m, -1).reshape(-1, axis_sizes[m]).tolist()):
            model_groups[j] = (dist.group.WORLD if len(members) == world
                               else dist.new_group(members))
    distributed.register_mesh(dm, flat, dp_groups, model_groups)
    mesh = _LIVE[key] = Mesh(axis_names, tuple(axis_sizes), device_type, ranks, dm)
    return mesh


def _device_type(device: Union[str, torch.device, None]) -> str:
    """The device type asked for (the card unless the caller asks for the
    CPU); a process group's backend must carry it. The `fake` backend of a
    dry run (`fake_world`) carries what the other two do: cuda (with a
    card) and cpu."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for but CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
    if distributed.is_fake():
        if dev.type not in ("cpu", "cuda"):
            raise RuntimeError(f"the fake process group carries cpu or cuda, not {dev.type}")
        return dev.type
    backend = distributed.backend_device_type()
    if backend is not None and backend != dev.type:
        raise RuntimeError(f"the process group's backend ({dist.get_backend()}) does not "
                           f"carry {dev.type} tensors")
    return dev.type


@contextlib.contextmanager
def fake_world(size: int):
    """A world of `size` ranks on the `fake` process-group backend, this
    process rank 0 (the dry run's: every collective returns at once and
    moves no byte), for the duration of the block. Afterwards the group, the
    cached meshes and their registered groups are gone, so a real group can
    start in the same process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if distributed.is_initialized():
        raise RuntimeError("a process group is already up; the fake world needs none")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _LIVE.clear()
        distributed.forget_meshes()


def init_from_env(device: Union[str, torch.device, None] = None) -> bool:
    """Start the default process group as `torchrun` describes it
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR/PORT): NCCL with this rank on
    cuda:LOCAL_RANK, or gloo on the CPU. Returns whether a group of more than
    one rank is up (already, or now)."""
    if distributed.is_initialized():
        return distributed.world_size() > 1
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torchrun rank asked for cuda, but CUDA is not available")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    return True


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device, None] = None) -> Mesh:
    """The assigned production mesh: 16x16 devices a pod; 2 pods multi-pod.
    Live when the world has exactly that many ranks, abstract otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if distributed.world_size() == math.prod(shape):
        return _live_mesh(shape, axes, _device_type(device))
    return Mesh(axes, shape, torch.device(device or "cuda").type)


def make_host_mesh(model_axis: int = 1,
                   device: Union[str, torch.device, None] = None) -> Mesh:
    """A (data, model) mesh over every rank of the world; with no process
    group, the 1-device mesh of this process. `device` is the card unless the
    caller asks for the CPU."""
    dtype = _device_type(device)
    n = distributed.world_size()
    if n % model_axis:
        raise ValueError(f"{n} devices do not divide model_axis={model_axis}")
    if not distributed.is_initialized():
        return Mesh(("data", "model"), (1, 1), dtype)
    return _live_mesh((n // model_axis, model_axis), ("data", "model"), dtype)


def dp_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that jointly form the data-parallel dimension."""
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)


def axis_size(mesh, axes) -> int:
    size = 1
    for a in (axes if isinstance(axes, (tuple, list)) else (axes,)):
        size *= mesh.shape[a]
    return size
