"""Process-group and placement helpers for sharded state (the port's own:
the reference places arrays by `NamedSharding` and lets GSPMD move them; the
port places tensors as `DTensor`s on a `DeviceMesh` and moves them itself).

* The world is the default process group (gloo on the CPU, NCCL on the
  card); without one it is this process alone (`world_size()` 1, `rank()` 0).
* A live mesh (`launch.mesh.Mesh`) registers its groups here when it is
  built, on every rank of the world at once (process groups are made
  collectively): the flattened group of all its ranks, over which sums
  reduce in one all-reduce (so every rank sees the same bits), one
  data-parallel group for each index along the "model" axis, and one model
  group for each data-parallel index (the ranks along "model" that share
  their rows: tensor-parallel compute reduces over it).
* A sharded leaf is a DTensor whose placements are `Shard(d)` or
  `Replicate()` on each mesh dim. `local_chunk` cuts the local shard out of a
  full tensor as DTensor does (mesh dims in order, even chunks: the rules
  shard a dim only when the mesh axes divide it); `place` makes the DTensor,
  with an empty local tensor on a rank outside the mesh; `gather` is the
  full tensor again.
* `sharded_sum` is the global sum over the leaves of a tree whose leaves lie
  sharded: each rank sums its local shard, a shard held on several ranks
  (a `Replicate()` mesh dim) counts once, on the rank at index 0 of that
  dim, and one all-reduce over the flattened mesh adds the per-leaf parts.

* `dp_context` names the data-parallel group of the loss being computed
  (the sharded step installs it around its loss function, `engine.fused`):
  a loss term whose per-row parts do not average over a batch split (the
  MoE router's load-balancing aux) reduces its batch means over the group
  before it combines them.
* The sharded step computes on weights gathered one layer at a time
  (`gather_for_compute`: over the dp axes only where tensor-parallel code
  consumes the rank's "model" shard, else whole) and on the Megatron pair
  `copy_to_model` / `reduce_from_model` (f and g) around column- and
  row-parallel products (`models.partitioning`, `models.layers`);
  `reduce_scatter_to_model` and `gather_from_model` split a row-parallel
  sum over the last dim and join it back (rwkv6's channel mix).
* Sequence-parallel compute (the "fsdp_sp" profile: each rank of the model
  group computes its block of the sequence) moves activations between the
  blocks: `gather_seq` (k and v whole for attention; its gradient
  reduce-scattered back to the blocks), `halo_from_prev` (the previous
  block's last rows, for the causal conv and the token shift),
  `gather_stack` with the pure `state_prefix` (the SSD and wkv scans'
  entering states, chained over the blocks),
  `lse_combine` (decode attention over a cache split on the sequence;
  `lse_merge` its pure form over parts on one device),
  `group_sum` (a loss's shares summed), `global_mean` (a mean over
  positions that lie across the ranks: MESA's KL) and `broadcast_from`
  (the last block's rows, where a prefill needs the sequence's end).

Nothing here imports DTensor at module import: only code that meets a
sharded tensor does.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

# id(DeviceMesh) -> (the DeviceMesh, its flattened group, {model index: dp
# group}, {dp index: model group})
_MESH_GROUPS: dict[int, tuple[Any, Any, dict, dict]] = {}
# (dp group, its size) of the loss being computed, None outside a sharded
# step's loss function (set and reset by `dp_context`)
_DP: contextvars.ContextVar = contextvars.ContextVar("repro_torch_dp", default=None)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_fake() -> bool:
    """Whether the default group is the dry run's `fake` backend."""
    return is_initialized() and dist.get_backend() == "fake"


def backend_device_type() -> Optional[str]:
    """The device type the default group's backend carries ("cpu" for gloo,
    "cuda" for NCCL), None without a group."""
    if not is_initialized():
        return None
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def register_mesh(device_mesh, flat_group, dp_groups: dict, model_groups: dict) -> None:
    _MESH_GROUPS[id(device_mesh)] = (device_mesh, flat_group, dp_groups, model_groups)


def forget_meshes() -> None:
    """Drop every registered mesh (its process group is gone)."""
    _MESH_GROUPS.clear()


def mesh_groups(device_mesh) -> tuple[Any, dict]:
    """(flattened group, {model index: dp group}) of a registered mesh."""
    entry = _mesh_entry(device_mesh)
    return entry[1], entry[2]


def model_group(device_mesh) -> tuple[Any, int, int]:
    """(this rank's model group, its size m, this rank's index in it) on a
    registered mesh: the ranks along "model" at this rank's dp index (None
    and 1 without a "model" axis of more than one rank)."""
    names = tuple(device_mesh.mesh_dim_names)
    if "model" not in names or device_mesh.shape[names.index("model")] == 1:
        return None, 1, 0
    m = names.index("model")
    idx, _ = dp_index(device_mesh, [d for d in range(len(names)) if d != m])
    return _mesh_entry(device_mesh)[3][idx], device_mesh.shape[m], device_mesh.get_coordinate()[m]


def _mesh_entry(device_mesh) -> tuple:
    entry = _MESH_GROUPS.get(id(device_mesh))
    if entry is None:
        # a DeviceMesh equal to a registered one (DTensor's sharding cache
        # may hand back an equal mesh object of an earlier world)
        entry = next((e for e in _MESH_GROUPS.values() if e[0] == device_mesh), None)
    if entry is None:
        raise RuntimeError("DeviceMesh not built by repro_torch.launch.mesh: its "
                           "groups are unknown")
    return entry


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_chunk(full: torch.Tensor, placements: Sequence, coord: Sequence[int],
                mesh_sizes: Sequence[int]) -> torch.Tensor:
    """This coordinate's shard of `full` under `placements` (a copy)."""
    out = full
    for p, c, n in zip(placements, coord, mesh_sizes):
        if p.is_shard():
            out = out.chunk(n, dim=p.dim)[c]
    return out.clone(memory_format=torch.contiguous_format)


def place(full: torch.Tensor, device_mesh, placements: Sequence) -> torch.Tensor:
    """`full` (the same values on every rank that calls this) as a DTensor on
    `device_mesh`: its local shard here, an empty tensor outside the mesh."""
    from torch.distributed.tensor import DTensor
    coord = device_mesh.get_coordinate()
    device = torch.device(device_mesh.device_type, _device_index(device_mesh.device_type))
    if coord is None:
        local = torch.empty(0, dtype=full.dtype, device=device)
    else:
        local = local_chunk(full, placements, coord, device_mesh.shape).to(device)
    return DTensor.from_local(local, device_mesh, tuple(placements), run_check=False,
                              shape=full.shape, stride=_contiguous_stride(full.shape))


def place_like(full: torch.Tensor, like) -> torch.Tensor:
    """`full` placed as the DTensor `like` is."""
    return place(full, like.device_mesh, like.placements)


def gather(x: torch.Tensor) -> torch.Tensor:
    """The full tensor of a DTensor (an all-gather over its mesh; an empty
    tensor outside the mesh), a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    if x.device_mesh.get_coordinate() is None:
        return torch.empty(0, dtype=x.dtype, device=x.to_local().device)
    return x.full_tensor()


def counts_here(x: torch.Tensor) -> bool:
    """Whether this rank's local shard of `x` is the one copy a global sum
    counts: index 0 along every mesh dim `x` is replicated over. A plain
    tensor (the same on every rank) counts on world rank 0 only."""
    if not is_dtensor(x):
        return rank() == 0
    coord = x.device_mesh.get_coordinate()
    if coord is None:
        return False
    return all(c == 0 for p, c in zip(x.placements, coord) if not p.is_shard())


def sharded_sum(leaves: Sequence[torch.Tensor], part: Callable[..., torch.Tensor],
                *others: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum over i of part(local_i, *others_local_i) across the mesh of the
    DTensor leaves, as a plain fp32 0-d tensor, the same bits on every rank
    of the mesh. `part` maps local tensors to a 0-d fp32 partial sum."""
    mesh = next(x.device_mesh for x in leaves if is_dtensor(x))
    flat, _ = mesh_groups(mesh)
    device = leaves[0].to_local().device if is_dtensor(leaves[0]) else leaves[0].device
    parts = []
    for i, x in enumerate(leaves):
        if counts_here(x):
            locs = [t.to_local() if is_dtensor(t) else t for t in (x, *(o[i] for o in others))]
            parts.append(part(*locs).float())
        else:
            parts.append(torch.zeros((), dtype=torch.float32, device=device))
    vec = torch.stack(parts) if parts else torch.zeros(1, device=device)
    dist.all_reduce(vec, group=flat)
    return torch.sum(vec)


def dp_index(device_mesh, dp_dims: Sequence[int]) -> tuple[int, int]:
    """(this rank's index along the data-parallel dims, their size)."""
    coord = device_mesh.get_coordinate()
    idx, n = 0, 1
    for d in dp_dims:
        size = device_mesh.shape[d]
        idx, n = idx * size + coord[d], n * size
    return idx, n


def _rows_over(x, dp_dims: Sequence[int]) -> bool:
    """Whether DTensor x shards its rows (dim 0) over exactly the mesh dims
    `dp_dims`, as `launch.sharding.batch_spec_tree` places a batch."""
    return bool(dp_dims) and all(p.is_shard(0) == (i in dp_dims)
                                 for i, p in enumerate(x.placements))


def dp_rows(x: torch.Tensor, dp_dims: Sequence[int], idx: int, n: int) -> torch.Tensor:
    """This rank's rows of batch leaf x, the batch split over n data-parallel
    ranks (this one at `idx`): a DTensor placed on its rows over the dp dims
    gives its local shard, the same rows; any other leaf is sliced (a
    DTensor gathered first)."""
    if is_dtensor(x):
        if _rows_over(x, dp_dims):
            return x.to_local()
        x = gather(x)
    m = x.shape[0] // n
    return x[idx * m:(idx + 1) * m]


def row_chunk(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch i of n of batch leaf x: its rows [i b/n, (i+1) b/n), as
    the reference chunks a batch. A DTensor placed on its rows gives that
    global chunk placed as x is: the rows move between ranks (an all-gather
    of the leaf, token ids or stub inputs) and each rank keeps its share; a
    chunk whose rows do not divide the placement comes whole on every rank."""
    b = x.shape[0]
    if is_dtensor(x) and any(p.is_shard(0) for p in x.placements):
        chunk = gather(x)[i * (b // n):(i + 1) * (b // n)]
        ways = 1
        for p, size in zip(x.placements, x.device_mesh.shape):
            ways *= size if p.is_shard(0) else 1
        return place(chunk, x.device_mesh, x.placements) if chunk.shape[0] % ways == 0 else chunk
    return x[i * (b // n):(i + 1) * (b // n)]


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """`obj` as rank `src` has it, on every rank of the world. On the
    dry run's fake backend this process is every rank: nothing moves (an
    object's broadcast would stage through a device tensor)."""
    if world_size() == 1 or is_fake():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_tensor(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """`t` as rank `src` has it, on every rank of the world (every rank
    passes a tensor of the same shape and dtype; on the fake backend `t`)."""
    if world_size() == 1 or is_fake():
        return t
    t = t.contiguous()
    if t.dtype == torch.bool:
        buf = t.to(torch.uint8)
        dist.broadcast(buf, src=src)
        return buf.bool()
    dist.broadcast(t, src=src)
    return t


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _device_index(device_type: str) -> Optional[int]:
    if device_type == "cuda":
        return torch.cuda.current_device()
    return None


# ---------------------------------------------------------------------------
# Data-parallel compute on sharded weights (the sharded step, engine.fused)
# ---------------------------------------------------------------------------

class _GatherForCompute(torch.autograd.Function):
    """Forward: the weight gathered over every mesh dim but `keep` (a mesh
    dim whose shard stays: the "model" shard that tensor-parallel code
    consumes; None: the full tensor). Backward: this rank's gradient of
    that tensor, all-reduced over `group` (in fp32 for narrower dtypes) and
    divided by `n`, then cut to the leaf's own shard."""

    @staticmethod
    def forward(ctx, x, keep, group, n):
        from torch.distributed.tensor import Replicate
        ctx.mesh, ctx.placements, ctx.shape = x.device_mesh, x.placements, x.shape
        ctx.keep, ctx.group, ctx.n = keep, group, n
        gathered = [i for i, p in enumerate(x.placements) if p.is_shard() and i != keep]
        if not gathered:
            # nothing moves: the result would alias the stored leaf
            return x.to_local().clone()
        if keep is None:
            return x.full_tensor()
        target = [p if i == keep else Replicate() for i, p in enumerate(x.placements)]
        return x.redistribute(x.device_mesh, target).to_local()

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate
        g = g.contiguous()
        if ctx.group is not None:
            red = g.float() if g.dtype in (torch.bfloat16, torch.float16) else g.clone()
            dist.all_reduce(red, group=ctx.group)
            g = (red.div_(ctx.n) if ctx.n > 1 else red).to(g.dtype)
        if ctx.keep is None:
            return place(g, ctx.mesh, ctx.placements), None, None, None
        cut = [Replicate() if i == ctx.keep else p for i, p in enumerate(ctx.placements)]
        local = local_chunk(g, cut, ctx.mesh.get_coordinate(), ctx.mesh.shape)
        return (DTensor.from_local(local, ctx.mesh, ctx.placements, run_check=False,
                                   shape=ctx.shape, stride=_contiguous_stride(ctx.shape)),
                None, None, None)


def gather_for_compute(x: torch.Tensor, group=None, n: int = 1, keep: Optional[int] = None
                       ) -> torch.Tensor:
    """Sharded weight `x` gathered for compute, differentiable: the full
    tensor, or with `keep` (a mesh dim) this rank's shard along that dim
    whole over every other. Its gradient comes back all-reduced over
    `group` (None: not reduced), divided by `n` and placed as `x`: the
    data-parallel group and its size average the ranks' gradients of their
    rows; the flattened group (or the model group with `n` 1) also sums
    the parts of a weight that the ranks along "model" each used a part of.
    A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    return _GatherForCompute.apply(x, keep, group, n)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; the gradient all-reduced (summed)
    over the model group, since each rank's column shard sees a part of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the forward summed over the model group (the row shards'
    partial products); the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x: torch.Tensor, group, m: int) -> torch.Tensor:
    """The m ranks' x of `group` concatenated on the last dim (an all-gather)."""
    parts = [torch.empty_like(x) for _ in range(m)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class _GatherFromModel(torch.autograd.Function):
    """The model group's shards of a tensor concatenated on its last dim;
    the gradient is this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, group, m, r):
        ctx.r, ctx.w = r, x.shape[-1]
        return _gather_last(x, group, m)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.r * ctx.w:(ctx.r + 1) * ctx.w], None, None, None


class _ReduceScatterToModel(torch.autograd.Function):
    """Forward: this rank's block of the last dim of the sum over the model
    group of each rank's partial x (a reduce-scatter). Backward: the
    blocks' gradients all-gathered, the gradient of every rank's partial."""

    @staticmethod
    def forward(ctx, x, group, m, r):
        ctx.group, ctx.m = group, m
        return _reduce_scatter(x, -1, group, m, r)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group, ctx.m), None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """f before a column-parallel product (the identity without autograd)."""
    return _CopyToModel.apply(x, group) if torch.is_grad_enabled() else x


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """g after a row-parallel product: the sum over the model group."""
    return _ReduceFromModel.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group of each rank's partial x, which every
    rank then uses on its own part (mamba2's gated norm's sum of squares
    over the rank's columns): forward and backward both sum over the
    group (g, then f)."""
    return copy_to_model(reduce_from_model(x, group), group)


def gather_from_model(x: torch.Tensor, group, m: int, r: int) -> torch.Tensor:
    """The whole of a tensor split on its last dim over the model group."""
    return _GatherFromModel.apply(x, group, m, r)


def reduce_scatter_to_model(x: torch.Tensor, lay) -> torch.Tensor:
    """The sum over `lay`'s model group of the ranks' partial x (..., D),
    this rank's block (..., D/m) of it (rwkv6's channel-mix value before
    its gate)."""
    return _ReduceScatterToModel.apply(x, lay.model_group, lay.m, lay.r)


def all_heads(t: torch.Tensor, lay) -> torch.Tensor:
    """Every head of t (..., H/m, X), of which each rank of `lay`'s model
    group holds its H/m, in rank order: (..., H, X) (decode's queries)."""
    whole = gather_from_model(t.flatten(-2), lay.model_group, lay.m, lay.r)
    return whole.unflatten(-1, (-1, t.shape[-1]))


# ---------------------------------------------------------------------------
# Sequence-parallel compute (the "fsdp_sp" profile, models.partitioning)
# ---------------------------------------------------------------------------

def _reduce_scatter(g: torch.Tensor, dim: int, group, m: int, r: int) -> torch.Tensor:
    """This rank's block r of m along `dim` of the sum over `group` of g: a
    reduce-scatter (gloo has none: an all-reduce and this rank's slice)."""
    w = g.shape[dim] // m
    if dist.get_backend(group) == "gloo":
        red = g.contiguous().clone()
        dist.all_reduce(red, group=group)
        return red.narrow(dim, r * w, w).contiguous()
    src = g.movedim(dim, 0).contiguous()
    out = src.new_empty((w, *src.shape[1:]))
    # the same call under its newer name where the installed torch has it
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _GatherSeq(torch.autograd.Function):
    """Forward: the blocks of the model group concatenated on `dim` (an
    all-gather). Backward: each block's gradient summed over the ranks that
    used the whole (each rank's attention reads every block's k and v), and
    this rank's block of it (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group, m, r):
        ctx.dim, ctx.group, ctx.m, ctx.r = dim, group, m, r
        parts = [torch.empty_like(x) for _ in range(m)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.m, ctx.r), None, None, None, None


def gather_seq(x: torch.Tensor, lay, dim: int = 1) -> torch.Tensor:
    """The whole sequence of a tensor of which each rank of `lay`'s model
    group holds its block along `dim` (k or v: (B, S/m, K, hd) -> (B, S, K,
    hd); rwkv6's r, k and v on their channels, dim -1, in the column
    layout); differentiable, its gradient reduce-scattered back to the
    blocks."""
    return _GatherSeq.apply(x, dim, lay.model_group, lay.m, lay.r)


def gather_stack(x: torch.Tensor, lay) -> torch.Tensor:
    """Each model rank's `x` stacked on a new leading dim (m, *x.shape), in
    rank order; differentiable as `gather_seq`: rank j's gradient is the sum
    over the ranks of their gradients of entry j."""
    return gather_seq(x.unsqueeze(0), lay, dim=0)


class _HaloFromPrev(torch.autograd.Function):
    """Forward: the previous rank's last w rows along dim 1 (zeros on rank
    0). Backward: the next rank's halo gradient, added to this rank's last w
    rows (rank m-1's tail feeds no one). Both directions move the tails by
    an all-gather over the model group: w rows a rank."""

    @staticmethod
    def forward(ctx, x, w, group, m, r):
        ctx.shape, ctx.w, ctx.group, ctx.m, ctx.r = x.shape, w, group, m, r
        tail = x[:, x.shape[1] - w:].contiguous()
        parts = [torch.empty_like(tail) for _ in range(m)]
        dist.all_gather(parts, tail, group=group)
        return parts[r - 1] if r > 0 else torch.zeros_like(tail)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(ctx.m)]
        dist.all_gather(parts, g, group=ctx.group)
        gx = g.new_zeros(ctx.shape)
        if ctx.r < ctx.m - 1:
            gx[:, ctx.shape[1] - ctx.w:] = parts[ctx.r + 1]
        return gx, None, None, None, None


def halo_from_prev(x: torch.Tensor, w: int, lay) -> torch.Tensor:
    """(B, w, C): the w rows before this rank's block of x (B, S/m, C), the
    previous rank's last w; zeros on rank 0, where the sequence starts.
    Differentiable: the gradient goes back to rank r-1. Needs S/m >= w."""
    if x.shape[1] < w:
        raise ValueError(f"a block of {x.shape[1]} rows is shorter than the halo's {w}")
    return _HaloFromPrev.apply(x, w, lay.model_group, lay.m, lay.r)


def state_prefix(s_all: torch.Tensor, l_all: torch.Tensor, r: int) -> torch.Tensor:
    """The state entering block r of a linear scan cut into blocks, from
    every block's zero-start final state s_all (m, B, H, ...) and its log
    decay l_all: (m, B, H) for the SSD scan (a_h times the block's sum of
    dt, broadcast over the state's P and N), (m, B, H, K) for the wkv
    scan (the block's sum of the per-key log decay, broadcast over V).
    The exclusive prefix h_r = sum_{j<r} exp(sum_{j<i<r} l_i) s_j, folded
    in s_all's dtype as h <- exp(l_j) h + s_j over j < r. A pure function
    of the gathered lists, the same on every rank for the same r. The
    result depends on every entry (`_Tie`: a zero gradient for those from
    block r on, rank 0's all), so each rank's gather runs its backward."""
    h = torch.zeros_like(s_all[0])
    pad = (1,) * (s_all.dim() - l_all.dim())
    for j in range(r):
        h = h * torch.exp(l_all[j]).reshape(*l_all.shape[1:], *pad) + s_all[j]
    return _Tie.apply(h, s_all, l_all)


class _Tie(torch.autograd.Function):
    """Forward: t. Backward: g for t and a zero gradient for each of
    `others`, which makes their producers' backward (a collective) run on a
    rank whose t does not read them."""

    @staticmethod
    def forward(ctx, t, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.others))


def lse_rescale(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, mx: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One part of softmax attention over split keys, its row max m (...,
    Sq), sum of exponentials l = sum exp(s - m) and unnormalised output o =
    sum exp(s - m) v (..., Sq, hd_v), rescaled to the parts' max mx: (l, o)
    times exp(m - mx). A part that sees no key (m at the masked score)
    weighs 0."""
    scale = torch.exp(m - mx)
    return l * scale, o * scale[..., None]


def lse_merge(m_all: torch.Tensor, l_all: torch.Tensor, o_all: torch.Tensor) -> torch.Tensor:
    """The pure combine of parts stacked on dim 0 (what `lse_combine` does
    across ranks): every part rescaled to their max, l and o summed, o / l."""
    l, o = lse_rescale(m_all, l_all, o_all, m_all.amax(dim=0))
    return o.sum(dim=0) / l.sum(dim=0).clamp_min(1e-30)[..., None]


def lse_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, group) -> torch.Tensor:
    """Softmax attention over keys split across `group`, from each rank's
    part (m, l, o) in fp32 (`lse_rescale`): `lse_merge` over the group's
    ranks, the max and the sums by all-reduces."""
    mx = m.clone()
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
    l, o = lse_rescale(m, l, o, mx)
    dist.all_reduce(l, group=group)
    dist.all_reduce(o, group=group)
    return o / l.clamp_min(1e-30)[..., None]


class _ScaleGrad(torch.autograd.Function):
    """Forward: t. Backward: g times s."""

    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def scale_grad(t: torch.Tensor, s: float) -> torch.Tensor:
    """t, its gradient scaled by s: a term every rank of a group computes
    whole, of whose gradient each rank takes 1/m (s) where the group sums
    the gradients (the MoE aux under the tensor-parallel layout)."""
    return _ScaleGrad.apply(t, s) if torch.is_grad_enabled() else t


class _GroupSum(torch.autograd.Function):
    """Forward: the sum over `group` of each rank's t. Backward: the
    identity: each rank differentiates its own share, and the gradients of
    the weights it used are summed over the group where they are gathered
    (`gather_for_compute`)."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    return _GroupSum.apply(t, group)


def broadcast_from(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """`t` as the rank at index `src` of `group` has it, on every rank of
    the group (no autograd: the prefill's cache and last position)."""
    t = t.clone(memory_format=torch.contiguous_format)
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


class _DPMean(torch.autograd.Function):
    """Forward: the mean over the data-parallel group of each rank's loss on
    its rows. Backward: the identity, so each rank differentiates its own
    term and `_GatherForCompute` averages the gradients."""

    @staticmethod
    def forward(ctx, t, group, n):
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def global_mean(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of every entry of t over the ranks of `group`, which hold
    different entries (a dp group's rows, the sequence blocks, or both),
    on every rank; None: t's own mean. Each rank differentiates its share,
    its sum over the global count, times the n ranks of the dp group over
    which the weights' gradients are averaged (as `dp_mean`'s term)."""
    if group is None:
        return t.mean()
    count = torch.tensor(float(t.numel()), dtype=torch.float32, device=t.device)
    dist.all_reduce(count, group=group)
    return _DPMean.apply(t.sum() * (n / count), group, n)


def dp_mean(t: torch.Tensor, group, n: int, differentiable: bool = True) -> torch.Tensor:
    if n <= 1:
        return t
    if differentiable:
        return _DPMean.apply(t, group, n)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out / n


@contextlib.contextmanager
def dp_context(dp: Optional[tuple[Any, int]]):
    """Within: `current_dp()` is `dp`, a (data-parallel group, its size n)
    over which each rank computes the loss on its slice of the batch, or
    None (the meshless loss, or a batch every rank computes whole). A size
    of 1 is taken as None. Reset on exit, so nothing outlives the call."""
    token = _DP.set(dp if dp is not None and dp[1] > 1 else None)
    try:
        yield
    finally:
        _DP.reset(token)


def current_dp() -> Optional[tuple[Any, int]]:
    """The (group, n) of the enclosing `dp_context`, None outside one."""
    return _DP.get()
