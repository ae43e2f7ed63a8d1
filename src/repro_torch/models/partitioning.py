"""Parameter sharding rules (counterpart of `repro.models.partitioning`).

The parameter rules live here, as in the reference: 2-axis FSDP x TP, with
the reference's name tables and fits, rule for rule (`make_rules`,
`param_partition_spec`; `launch.sharding` applies them to whole trees). A
`PartitionSpec` is the port's own: a tuple with one entry per tensor dim,
each None (replicated), an axis name, or a tuple of axis names (the dim
sharded over all of them, the first outermost).
`launch.sharding.to_placements` turns it into DTensor placements.

The reference's activation constraints (`activation_sharding`, `constrain`,
`constrain_first_fit`, `constrain_param_tree`) are not ported: they pin
GSPMD's layouts at call sites in its model bodies and scan loops, and the
port's models have neither: its sharded step computes on gathered,
unsharded weights (`engine.fused`), so there is nothing to pin. Without an
active mesh they are no-ops in the reference too.
"""
from __future__ import annotations

from typing import Any

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
    cast is shard-local, so every gather and gradient reduction after it
    moves the narrower dtype); 1-D leaves (norm scales, biases) stay fp32."""
    if not getattr(cfg, "weight_stream_bf16", False):
        return tree
    dt = getattr(torch, cfg.compute_dtype)

    def f(x):
        return x.to(dt) if x.dim() >= 2 and x.dtype == torch.float32 else x

    from repro_torch.utils import trees
    return trees.tree_map(f, tree)
