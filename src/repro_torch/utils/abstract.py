"""Abstract tracing: state with shapes and no storage, and one traced step's
record (the port's own; its counterparts in the reference are
`jax.eval_shape`, a lowered step and the compiled step's memory and cost
analyses).

* `fake_mode()` is a `FakeTensorMode`. A tensor made under it has a shape,
  a dtype and a device and no data, so a full-size state costs nothing and
  nothing is allocated on a device. The kernels' wrappers launch through
  `torch.library` custom ops whose fake implementations give their outputs'
  shapes, so a fake CUDA tensor takes the card's path, kernels included.
* `trace(fn, *args)` runs `fn(*args)` once under dispatch modes that record
  what it does (`Lowered`): the ops by name, the flops
  (`torch.utils.flop_counter.FlopCounterMode`, with the kernels' formulas
  registered beside them), the collectives, the kernels, and this rank's
  argument, output and peak live bytes. The tensors may be fake or real:
  the same function traced on each gives the same record, except that real
  tensors also compute.

Live bytes are tracked here, not by `MemTracker`: every tensor storage an
op creates (a DTensor's local one) is counted from the op that makes it
until the storage is freed (a weak reference's finalizer), on top of the
arguments' storages. Storages made where no mode sees them (inside a
DTensor's own dispatch, or a kernel's scratch inside its real launch) are
counted from their first use by a traced op, or not at all. Ops on meta
tensors (shapes only) are not recorded.

Collectives are read from the traced `c10d` / `_c10d_functional` ops, one
record each: `kind` in the reference's vocabulary (all-reduce, all-gather,
reduce-scatter, all-to-all, collective-permute; a broadcast counts as a
collective-permute, one sender's bytes to each of the others), `bytes` the
result's bytes on this rank, `group` the group's size.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
KERNEL_NAMESPACE = "repro_torch"


def fake_mode():
    """A fresh `FakeTensorMode`: enter it to make tensors with no data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _skip_gpu_probe()
    return FakeTensorMode()


def _skip_gpu_probe() -> None:
    """Making a fake CUDA tensor, PyTorch first makes (and frees) a real
    one-element tensor on the card, to be sure a CUDA context exists
    (`fake_tensor.init_gpu_context`). Once the context exists the probe only
    allocates, and the dry run must allocate nothing on the card: from then
    on it is skipped (process-wide, once)."""
    from torch._subclasses import fake_tensor as ft
    probe = ft.init_gpu_context
    if getattr(probe, "skips_once_initialized", False):
        return

    def init_gpu_context(device: torch.device) -> None:
        if not (device.type == "cuda" and torch.cuda.is_initialized()):
            probe(device)

    init_gpu_context.skips_once_initialized = True
    ft.init_gpu_context = init_gpu_context


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor as it is."""
    inner = getattr(t, "_local_tensor", None)
    return inner if isinstance(inner, torch.Tensor) else t


def is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(local(t), FakeTensor)


def fake_mode_of(tree) -> Any:
    """The FakeTensorMode the tree's fake tensors belong to (None: none is
    fake)."""
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor) and is_fake(x):
            return local(x).fake_mode
    return None


def nbytes(t: torch.Tensor) -> int:
    """Bytes of this rank's elements of t (a DTensor's local shard)."""
    t = local(t)
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages the tree's tensors (their local
    shards) lie in: what the tree holds on this rank."""
    seen, total = set(), 0
    for x in tensors(tree):
        st = x.untyped_storage()
        key = st._cdata
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


def tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree that may hold host values (a TrainState), a
    DTensor as its local shard."""
    from repro_torch.utils import trees
    leaves = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            leaves.append(local(x))
        elif x is not None and not isinstance(x, (int, float, bool, str)):
            leaves.extend(local(t) for t in trees.tree_leaves(x)
                          if isinstance(t, torch.Tensor))
    return leaves


@dataclasses.dataclass
class Lowered:
    """One traced step: the port's "lowered" step (see the module
    docstring). `bytes_accessed` is the sum over the traced ops of their
    tensor inputs' and outputs' bytes (each view at its own size; an
    in-place op's operand counted as read and as written)."""
    ops: dict = dataclasses.field(default_factory=dict)
    flops: int = 0
    collectives: list = dataclasses.field(default_factory=list)
    kernels: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    bytes_accessed: int = 0


class _Recorder(TorchDispatchMode):
    """Counts ops, kernels, collectives, bytes accessed and live storages."""

    def __init__(self, rec: Lowered):
        super().__init__()
        self.rec = rec
        self.ops: Counter = Counter()
        self.kernels: Counter = Counter()
        self.live: dict[int, int] = {}
        self.live_bytes = 0

    def track(self, t: torch.Tensor) -> None:
        st = local(t).untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        weakref.finalize(st, self._free, key)
        if self.live_bytes > self.rec.peak_bytes:
            self.rec.peak_bytes = self.live_bytes

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "prim":                     # metadata queries of a subclass
            return out
        ins = _flat_tensors(args, [])
        if kwargs:
            _flat_tensors(kwargs.values(), ins)
        outs = _flat_tensors((out,), [])
        if ins + outs and all(t.device.type == "meta" for t in ins + outs):
            return out                       # shapes only: no memory, no work
        name = func._opname
        self.ops[f"{ns}.{name}"] += 1
        accessed = 0
        for t in ins + outs:
            self.track(t)
            accessed += nbytes(t)
        self.rec.bytes_accessed += accessed
        if ns == KERNEL_NAMESPACE:
            self.kernels[name] += 1
        elif ns in _COMM_NAMESPACES and name in _COLLECTIVES:
            self.rec.collectives.append(dict(
                kind=_COLLECTIVES[name], bytes=sum(nbytes(t) for t in (outs or ins)),
                group=_group_size(args, kwargs)))
        return out


def _flat_tensors(items, acc: list) -> list:
    """The tensors among `items`, lists and tuples of them searched."""
    for x in items:
        if isinstance(x, torch.Tensor):
            acc.append(x)
        elif isinstance(x, (list, tuple)):
            _flat_tensors(x, acc)
    return acc


def _group_size(args, kwargs) -> int:
    """The size of a collective's process group: a ProcessGroup argument
    (c10d's ops take it boxed) or a group's name (_c10d_functional's)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for x in list(args) + list(kwargs.values()):
        if isinstance(x, torch.ScriptObject) and "ProcessGroup" in str(x._type()):
            return dist.ProcessGroup.unbox(x).size()
        if isinstance(x, dist.ProcessGroup):
            return x.size()
        if isinstance(x, str):
            try:
                return _resolve_process_group(x).size()
            except (KeyError, RuntimeError, ValueError):
                continue
    return 1


def trace(fn: Callable, *args) -> tuple[Any, Lowered]:
    """fn(*args) once under the recording modes (and under the fake mode of
    any fake argument): (its output, the record)."""
    from torch.utils.flop_counter import FlopCounterMode

    _skip_gpu_probe()
    rec = Lowered()
    recorder = _Recorder(rec)
    for t in tensors(args):
        recorder.track(t)
    rec.argument_bytes = recorder.live_bytes
    mode = fake_mode_of(args)
    with (mode if mode is not None else contextlib.nullcontext()), \
            FlopCounterMode(display=False) as flops, recorder:
        out = fn(*args)
    rec.output_bytes = storage_bytes(out)
    rec.ops = dict(recorder.ops)
    rec.kernels = dict(recorder.kernels)
    rec.flops = int(flops.get_total_flops())
    return out, rec

