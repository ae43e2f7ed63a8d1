"""Parameter sharding rules and the activation layout of a sharded step
(counterpart of `repro.models.partitioning`).

The parameter rules live here, as in the reference: 2-axis FSDP x TP, with
the reference's name tables and fits, rule for rule (`make_rules`,
`param_partition_spec`; `launch.sharding` applies them to whole trees). A
`PartitionSpec` is the port's own: a tuple with one entry per tensor dim,
each None (replicated), an axis name, or a tuple of axis names (the dim
sharded over all of them, the first outermost).
`launch.sharding.to_placements` turns it into DTensor placements.

The reference pins GSPMD's activation layouts with `constrain` under
`activation_sharding(mesh)` and re-pins each scanned layer's weights with
`constrain_param_tree`, so that they are gathered one layer at a time. The
port computes the same layout by hand. `activation_sharding(mesh)` installs
this rank's `Layout` (its model group, its index along "model", the rules);
without one (meshless, or a 1-device mesh) every helper here is the
identity and the model code runs as it always did. Under a layout:
  * `Layout.splits` is `constrain`'s per-dim rule: a dim is sharded over
    its mesh axes only when their size divides it, else replicated;
  * `gather_block` / `gather_part` are `constrain_param_tree`: a block's
    leaves gathered where the block runs (inside its checkpointed function,
    so a recompute gathers again). A leaf that tensor-parallel code
    consumes is gathered over the dp axes only and keeps this rank's
    "model" shard, the Megatron column or row slice the rules give it
    (`tp_leaves`); any other leaf is gathered whole;
  * tensor parallelism covers the "tp" profile's attention (heads that
    divide "model", MLA's too), MLP (d_ff), MoE experts and embedding /
    logits (vocab) of every family (`tp_enabled`). The experts keep their
    "model" shard as the rules place it: EP's E/m experts where m divides
    E (deepseek's 64 on 16), else expert TP's f/m columns of we_in /
    we_gate and rows of we_out (mixtral's 8 on 16); the router is
    computed whole on every rank, the shared experts are an MLP on their
    d_ff (`moe.moe_apply`). rwkv6's time mix runs on the rank's heads
    where they divide "model" (r, k, v, g and the decay on its columns,
    the wkv scan and the per-head norm on its heads, `wo` row-parallel),
    else on its d_model / m columns where "model" divides d_model, as the
    reference pins r, k, v and g on their channels whatever the heads (r,
    k and v all-gathered whole, the decay, the scan and the norm on every
    head, the rank's columns of y gated and through `wo`'s rows), its
    channel mix on its d_ff
    (`wv_c`'s partial sums reduce-scattered over d_model, the receptance
    gate on the rank's columns of `wr_c`, the gated product all-gathered;
    `models.rwkv`); f sits on each mix's normed input, so every leaf of
    the mix that is not split is partial. mamba2 runs on the rank's heads
    where they divide "model" (`wz`, `wx`, `wdt` and the x conv on its
    d_inner columns and heads, the SSD scan on its heads, the gated norm's
    sum of squares summed over the group, `w_out` row-parallel; B and C
    whole on every rank, `wbc` and the BC conv partial leaves;
    `models.ssm`), and the hybrid family's shared block takes the layout
    of `attn` and `mlp`, its LoRA added once after their sums. The
    encoder-decoder's self-attention, cross-attention and MLP take the
    layout of `attn` and `mlp` (`tp_leaves`). Under "tp" a decode cache
    whose kv heads do not carry it ("model" not dividing both head
    counts, or MLA's latents) stays on its sequence blocks, as the serve
    step holds it (`cache_sequence`): each rank attends with every query
    head over its block and the parts are combined
    (`distributed.lse_combine`); the encoder-decoder's cross k/v likewise
    over theirs;
  * sequence parallelism covers the "fsdp_sp" profile of every family
    (`sp_enabled`): rank r of the model group computes its block [r S/m,
    (r+1) S/m) of the sequence on whole weights, each leaf gathered with
    its gradient summed over the model group (every rank used all of it
    on its own tokens) and averaged over dp. `sequence_block` installs the
    block for the model code (`seq_block`): attention gathers k and v
    whole and runs the flash kernel with the block's query offset (MLA's
    k and v from the block's latents; cross-attention's from the
    encoder's blocks), the SSD and wkv scans chain their states across
    the blocks, the conv and the token shifts take the previous block's
    rows, a MoE layer dispatches each row's routes at their places in the
    whole row's buffers and takes the whole batch's aux, a vlm block its
    rows of the image-prefixed sequence, the encoder-decoder's encoder
    its block of the frames; the loss is the global mean of the blocks'
    labels (`registry`). A sequence that "model" does not divide (or
    whose blocks are shorter than the causal conv's halo of d_conv - 1
    rows for mamba2, of 1 for rwkv6's token shift) stays whole on every
    rank, as `constrain` leaves it, and its gradients are averaged over dp
    only (every rank computed all). The serve step splits a cache's
    sequence as it is stored (`cache_sequence`, `cache_block`), so decode
    combines the ranks' attention over their parts
    (`distributed.lse_combine`);
  * attention whose heads "model" does not divide, mamba2 whose heads it
    does not divide, and rwkv6's mixes whose dims it does not divide,
    compute on whole weights (as `constrain` drops the axis there).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional

import torch

Tree = Any


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def make_rules(mesh) -> dict:
    from repro_torch.launch.mesh import dp_axes

    dp = dp_axes(mesh)
    model = ("model",)

    def size(axes):
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        return n

    pod = ("pod",) if "pod" in mesh.axis_names else ()
    return {
        "batch": (dp, size(dp)),
        "model": (model, size(model)),
        "batch_model": (dp + model, size(dp + model)),
        # expert dim: span pods too so EP groups do not replicate per pod
        "pod_model": (pod + model, size(pod + model)),
        "data_only": (("data",), size(("data",))),
    }


# ---------------------------------------------------------------------------
# Parameter rules (FSDP x TP)
# ---------------------------------------------------------------------------

# leaf names whose (d_in, d_out) orientation is output-projection-like
_OUT_PROJ = {"wo", "wo_mlp", "w_out", "wv_c"}
# leaf names replicated outright (norm scales / tiny vectors / adapters)
_REPLICATED = {"scale", "bias", "kv_norm_scale", "gate_norm_scale", "ln_scale",
               "w0", "mix_r", "mix_k", "mix_v", "mix_w", "mix_g",
               "a_log", "d_skip", "dt_bias", "bonus_u",
               "attn_a", "attn_b", "mlp_a", "mlp_b",
               "decay_a", "decay_b"}
_BIAS_MODEL = {"bq", "bk", "bv", "conv_x_b", "conv_bc_b"}
_CONV_MODEL = {"conv_x_w", "conv_bc_w"}


def param_partition_spec(path: str, shape: tuple[int, ...], rules: dict) -> PartitionSpec:
    """PartitionSpec for one parameter (or mirrored optimizer-state) leaf of
    the reference's tree: `path` slash-joined, `shape` with the blocks'
    leading L axis where the reference stacks them."""
    dp, dp_n = rules["batch"]
    model, model_n = rules["model"]
    name = path.split("/")[-1]

    def fit(axes, n, dim):
        return axes if dim % n == 0 else None

    if name in _REPLICATED or len(shape) == 0:
        return P()
    if name == "embed":
        v, d = shape[-2], shape[-1]
        lead = (None,) * (len(shape) - 2)
        return P(*lead, fit(model, model_n, v), fit(dp, dp_n, d))
    if name in _BIAS_MODEL or name in _CONV_MODEL:
        lead = (None,) * (len(shape) - 1)
        return P(*lead, fit(model, model_n, shape[-1]))
    if name in ("we_in", "we_gate", "we_out"):
        lead = (None,) * (len(shape) - 3)
        e, di, do = shape[-3], shape[-2], shape[-1]
        # experts stay intra-pod (the reference measured pod-spanning EP to
        # cost more in all-to-alls than it saves)
        if e % model_n == 0:
            return P(*lead, model, fit(dp, dp_n, di), None)   # EP + FSDP
        if name == "we_out":  # TP over the contraction (f) dim
            return P(*lead, None, fit(model, model_n, di), fit(dp, dp_n, do))
        return P(*lead, None, fit(dp, dp_n, di), fit(model, model_n, do))
    if name == "router":
        lead = (None,) * (len(shape) - 2)
        return P(*lead, fit(dp, dp_n, shape[-2]), None)
    if len(shape) >= 2:
        di, do = shape[-2], shape[-1]
        lead = (None,) * (len(shape) - 2)
        if name in _OUT_PROJ:
            return P(*lead, fit(model, model_n, di), fit(dp, dp_n, do))
        return P(*lead, fit(dp, dp_n, di), fit(model, model_n, do))
    return P(*((None,) * (len(shape) - 1)), fit(model, model_n, shape[-1]))


def stream_cast(tree: Tree, cfg) -> Tree:
    """Cast >=2-D fp32 weights to the compute dtype before sharded use (the
    cast is shard-local, so every weight gather after it moves the narrower
    dtype; the gradients' all-reduce still runs in fp32,
    `distributed.gather_for_compute`); 1-D leaves (norm scales, biases)
    stay fp32."""
    if not getattr(cfg, "weight_stream_bf16", False):
        return tree
    dt = getattr(torch, cfg.compute_dtype)

    def f(x):
        return x.to(dt) if x.dim() >= 2 and x.dtype == torch.float32 else x

    from repro_torch.utils import trees
    return trees.tree_map(f, tree)


# ---------------------------------------------------------------------------
# Activation layout of a sharded step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in a sharded step's compute: the mesh dim of
    "model" (None without one), the model group (the ranks along "model" at
    this rank's dp index), its size m and this rank's index r in it, and the
    flattened group of the mesh."""
    model_dim: Optional[int]
    model_group: Any
    m: int
    r: int
    flat_group: Any
    # the sequence block this rank computes, (lo, hi) of the model code's
    # sequence (`sequence_block`); None: the whole sequence
    seq: Optional[tuple[int, int]] = None
    # a cache's sequence split as the serve step holds it (`cache_sequence`):
    # (this rank's block index, the number of blocks, the group over which
    # the blocks lie); None: the cache whole on every rank
    cache_seq: Optional[tuple[int, int, Any]] = None
    # the same for an encoder-decoder's cross k/v, whose length is the
    # encoder's (`cache_block(n, cross=True)`)
    cross_seq: Optional[tuple[int, int, Any]] = None

    def splits(self, size: int) -> bool:
        """The per-dim rule: whether a dim of `size` is sharded over "model"
        (its size divides it, and exceeds 1); else it is replicated."""
        return self.m > 1 and size % self.m == 0

    def shard_range(self, size: int) -> tuple[int, int]:
        """This rank's block [lo, hi) of a dim of `size` split over "model"."""
        w = size // self.m
        return self.r * w, (self.r + 1) * w


_LAYOUT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_layout", default=None)


def make_layout(mesh) -> Layout:
    """The layout of this rank on live sharded `mesh` (a `launch.mesh.Mesh`)."""
    from repro_torch.utils import distributed
    dm = mesh.device_mesh
    names = tuple(mesh.axis_names)
    flat, _ = distributed.mesh_groups(dm)
    group, m, r = distributed.model_group(dm)
    return Layout(names.index("model") if "model" in names else None, group, m, r, flat)


@contextlib.contextmanager
def activation_sharding(mesh):
    """Within: the model code computes in `mesh`'s layout on this rank (no
    layout for None, an abstract mesh, or a mesh that is not sharded);
    reset on exit."""
    live = mesh is not None and mesh.sharded and mesh.is_member
    token = _LAYOUT.set(make_layout(mesh) if live else None)
    try:
        yield
    finally:
        _LAYOUT.reset(token)


@contextlib.contextmanager
def layout_context(layout: Optional[Layout]):
    """Within: `current_layout()` is `layout` (a checkpointed block's
    recompute runs in the layout its forward ran in)."""
    token = _LAYOUT.set(layout)
    try:
        yield
    finally:
        _LAYOUT.reset(token)


def current_layout() -> Optional[Layout]:
    """The layout of the enclosing `activation_sharding`, None outside one."""
    return _LAYOUT.get()


def tp_layout(cfg) -> Optional[Layout]:
    """The layout when `cfg`'s modules compute tensor-parallel here: a
    layout with a "model" axis of more than one rank and the "tp"
    profile."""
    lay = current_layout()
    if lay is None or lay.m == 1 or not tp_enabled(cfg):
        return None
    return lay


def tp_enabled(cfg) -> bool:
    """Whether `cfg` computes tensor-parallel on a model axis: the "tp"
    profile, every family."""
    return cfg.sharding_profile == "tp"


def sp_enabled(cfg) -> bool:
    """Whether `cfg` computes sequence-parallel on a model axis: the
    "fsdp_sp" profile, every family (MLA too)."""
    return cfg.sharding_profile == "fsdp_sp"


def sp_layout(cfg) -> Optional[Layout]:
    """The layout when `cfg`'s model computes sequence-parallel here: a
    layout with a "model" axis of more than one rank and `sp_enabled`."""
    lay = current_layout()
    if lay is None or lay.m == 1 or not sp_enabled(cfg):
        return None
    return lay


def sp_range(cfg, seq_len: int) -> Optional[tuple[int, int]]:
    """This rank's block [lo, hi) of a sequence of `seq_len` under the
    sequence-parallel layout, None where it is computed whole: no such
    layout, "model" not dividing it, or blocks shorter than the rows a
    block reads from the previous one (`halo_rows`)."""
    lay = sp_layout(cfg)
    if lay is None or not lay.splits(seq_len) or seq_len // lay.m < halo_rows(cfg):
        return None
    return lay.shard_range(seq_len)


def halo_rows(cfg) -> int:
    """The rows a sequence block reads from the end of the previous one:
    mamba2's causal conv d_conv - 1, rwkv6's token shift 1, else 0."""
    if cfg.ssm is not None:
        return cfg.ssm.d_conv - 1
    return 1 if cfg.rwkv is not None else 0


@contextlib.contextmanager
def in_block(blk: Optional[tuple[int, int]]):
    """Within: the model code computes the block (lo, hi) of its sequence,
    which `seq_block` reads; None changes nothing."""
    if blk is None:
        yield None
        return
    with layout_context(dataclasses.replace(current_layout(), seq=blk)):
        yield blk


@contextlib.contextmanager
def sequence_block(cfg, seq_len: int):
    """Within: the model code computes this rank's block of a sequence of
    `seq_len` (`sp_range`), which `seq_block` reads; yields the block (lo,
    hi), or None (and changes nothing) where the sequence is whole."""
    with in_block(sp_range(cfg, seq_len)) as blk:
        yield blk


def seq_block() -> Optional[tuple[int, int]]:
    """The (lo, hi) of the enclosing `sequence_block`, None outside one."""
    lay = current_layout()
    return None if lay is None else lay.seq


@contextlib.contextmanager
def cache_sequence(index: int, ways: int, group, cross: Optional[tuple[int, int, Any]] = None):
    """Within: a cache's sequence dim lies in `ways` blocks over `group`,
    this rank holding block `index` (the serve step, `launch.steps`), and an
    encoder-decoder's cross k/v in `cross`'s (index, ways, group), None
    where they are whole; a no-op outside a layout, or for one block of
    each."""
    lay = current_layout()
    if cross is not None and cross[1] == 1:
        cross = None
    if lay is None or (ways == 1 and cross is None):
        yield
        return
    seq = (index, ways, group) if ways > 1 else None
    with layout_context(dataclasses.replace(lay, cache_seq=seq, cross_seq=cross)):
        yield


def _cache_seq(cross: bool) -> Optional[tuple[int, int, Any]]:
    lay = current_layout()
    return None if lay is None else (lay.cross_seq if cross else lay.cache_seq)


def cache_ways(cross: bool = False) -> int:
    """The number of blocks a cache's sequence (`cross`: an encoder-decoder's
    cross k/v's) lies in (`cache_sequence`), 1 where every rank holds it
    whole."""
    seq = _cache_seq(cross)
    return 1 if seq is None else seq[1]


def cache_block(n: int, cross: bool = False) -> Optional[tuple[int, int, Any]]:
    """(lo, hi, group) of this rank's block, of `n` positions, of a cache's
    sequence (`cross`: the cross k/v's) under `cache_sequence`; None where
    every rank holds it whole."""
    seq = _cache_seq(cross)
    if seq is None:
        return None
    index, _, group = seq
    return index * n, (index + 1) * n, group


_ATTN_Q = ("wq", "bq", "wo")
_ATTN_KV = ("wk", "wv", "bk", "bv")
_MLA_HEADS = ("wq", "w_uk", "w_uv", "wo")
_MLA_LATENT = ("w_dkv", "kv_norm_scale")
_EXPERTS = ("we_in", "we_gate", "we_out")
_ATTN_PARTS = ("attn", "self_attn", "cross_attn")
# rwkv6's leaves split over "model" under "tp" (`tp_leaves`, `rwkv_share`)
_RWKV_SPLIT = {"tm": ("wr", "wk", "wv", "wg", "wo"), "cm": ("wk_c", "wv_c", "wr_c")}
# mamba2's leaves split over "model" under "tp" (its d_inner columns and
# heads; `w_out`'s rows); the mixer's others are used whole or sliced
_MAMBA_SPLIT = ("wz", "wx", "wdt", "conv_x_w", "conv_x_b", "w_out")


def mamba_heads(cfg) -> int:
    """mamba2's heads: expand * d_model / head_dim."""
    return cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim


def rwkv_share(part: str, leaves: dict, r: int, m: int) -> dict:
    """rwkv6's `tm` or `cm` leaves as rank r of m holds them under the "tp"
    layout, cut from whole ones (views, so gradients reach the whole): each
    split leaf's block r on the dim `param_partition_spec` places over
    "model" (an output projection's rows, else its columns: the rank's
    heads' or, where m does not divide the heads, its d_model / m
    columns), the others whole. The collective-free pieces of
    `models.rwkv` run on it."""
    out = dict(leaves)
    for name in _RWKV_SPLIT[part]:
        dim = -2 if name in _OUT_PROJ else -1
        w = leaves[name].shape[dim] // m
        out[name] = leaves[name].narrow(dim, r * w, w)
    return out


def mamba_share(leaves: dict, r: int, m: int) -> dict:
    """mamba2's mixer leaves as rank r of m holds them under the "tp"
    layout, cut from whole ones (views): `wz`, `wx`, `wdt` and the x conv
    on the heads' columns, `w_out`'s rows, the others whole.
    `ssm.mamba2_gated` and `ssm.mamba2_out` run on it."""
    out = dict(leaves)
    for name in _MAMBA_SPLIT:
        dim = -2 if name in _OUT_PROJ else -1
        w = leaves[name].shape[dim] // m
        out[name] = leaves[name].narrow(dim, r * w, w)
    return out


def tp_leaves(part: str, leaves: dict, cfg, lay: Layout) -> tuple[tuple, tuple]:
    """(the leaves of a block part consumed model-sharded, the leaves used
    whole of which each model rank uses a part) under the tensor-parallel
    layout `lay`: attention on heads where `n_heads` divides "model" (its
    kv projections too where `n_kv_heads` does; else each rank computes
    them whole and uses its query heads' kv heads; MLA's latent is every
    rank's, its queries and up-projections the rank's heads), the MLP on
    d_ff, the MoE experts on EP's experts or expert TP's d_ff (the router
    computed whole, its gradient partial: each rank combines its share),
    rwkv6's time mix on its heads or, where "model" divides d_model but not
    the heads, on its columns (the same leaves split either way), and its
    channel mix on d_ff and d_model where both divide it (every other leaf
    of a split mix partial: f sits on the mix's normed input, so each
    rank's gradient of a mix coefficient, the decay's LoRA, w0, the bonus
    and the norm scale is its own heads' or columns' part), the embedding and the
    output head on the vocabulary; mamba2's mixer on its heads where they
    divide "model" (`wz`, `wx`, `wdt`, the x conv and `w_out` sharded;
    `wbc` and the BC conv used whole, the per-head and per-channel vectors
    sliced: all partial). The encoder-decoder's self- and cross-attention
    take `attn`'s layout."""
    if part == "mixer" and "wz" in leaves:
        if not lay.splits(mamba_heads(cfg)):
            return (), ()
        return _MAMBA_SPLIT, tuple(n for n in leaves if n not in _MAMBA_SPLIT)
    if part in _RWKV_SPLIT and _RWKV_SPLIT[part][0] in leaves:
        if part == "tm" and not lay.splits(cfg.d_model):
            return (), ()
        if part == "cm" and not (lay.splits(cfg.d_ff) and lay.splits(cfg.d_model)):
            return (), ()
        split = _RWKV_SPLIT[part]
        return split, tuple(n for n in leaves if n not in split)
    if part in _ATTN_PARTS and "wq" in leaves:
        if not lay.splits(cfg.n_heads):
            return (), ()
        if cfg.mla is not None:
            return _MLA_HEADS, _MLA_LATENT
        if lay.splits(cfg.n_kv_heads):
            return _ATTN_Q + _ATTN_KV, ()
        return _ATTN_Q, _ATTN_KV
    if part == "mlp" and "wi" in leaves and lay.splits(leaves["wi"].shape[-1]):
        return ("wi", "wg", "wo_mlp"), ()
    if part == "moe" and (lay.splits(cfg.moe.n_experts) or lay.splits(cfg.moe.expert_d_ff)):
        return _EXPERTS, ("router",)
    if part == "embedding" and lay.splits(cfg.vocab_size):
        return ("embed", "unembed"), ()
    return (), ()


def gather_leaf(x: torch.Tensor, keep_model: bool = False, partial: bool = False
                ) -> torch.Tensor:
    """One leaf gathered for compute in the current layout (see
    `gather_part`); a plain tensor, or no layout, gives `x` itself."""
    from repro_torch.utils import distributed
    lay = current_layout()
    if lay is None or not distributed.is_dtensor(x):
        return x
    dp = distributed.current_dp()
    if partial:
        group, n = (lay.flat_group, dp[1]) if dp is not None else (lay.model_group, 1)
    else:
        group, n = dp if dp is not None else (None, 1)
    keep = lay.model_dim if keep_model else None
    return distributed.gather_for_compute(x, group, n, keep)


def gather_part(part: str, leaves: dict, cfg) -> dict:
    """A block part's leaves (nested dicts too) gathered for compute: a
    leaf of `tp_leaves` keeps its "model" shard; a partly used leaf's
    gradient is summed over the model group, and so is every leaf's within
    a sequence block (each rank used it on its own block; a sequence left
    whole is every rank's, and its gradients are not summed); each
    gradient is averaged over the dp group of
    `utils.distributed.dp_context`. The identity without a layout."""
    lay = current_layout()
    if lay is None:
        return leaves
    tlay = tp_layout(cfg)
    keep, partial = tp_leaves(part, leaves, cfg, tlay) if tlay is not None else ((), ())
    if lay.seq is not None and sp_layout(cfg) is not None:
        partial = tuple(leaves)

    def one(name, x):
        if isinstance(x, dict):   # a moe part's shared experts: an MLP
            return gather_part("mlp" if name == "shared" else "", x, cfg)
        return gather_leaf(x, keep_model=name in keep, partial=name in partial)

    return {name: one(name, x) for name, x in leaves.items()}


def gather_block(bp: dict, cfg) -> dict:
    """A block's parameters ({part: {leaf: tensor}}) gathered for compute
    (`gather_part` on each part); the identity without a layout."""
    if current_layout() is None:
        return bp
    return {part: gather_part(part, leaves, cfg) for part, leaves in bp.items()}


def local_kv_heads(cfg) -> int:
    """The kv heads of an attention cache on this rank: n_kv_heads / m
    where the tensor-parallel layout splits the heads and the kv heads over
    "model", else n_kv_heads (MLA's latents have none)."""
    lay = tp_layout(cfg)
    if lay is not None and lay.splits(cfg.n_heads) and lay.splits(cfg.n_kv_heads):
        return cfg.n_kv_heads // lay.m
    return cfg.n_kv_heads
