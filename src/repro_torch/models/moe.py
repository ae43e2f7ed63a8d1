"""Mixture-of-Experts layer: top-k router + capacity-based dispatch
(counterpart of `repro.models.moe`).

The routing is the reference's "dropping" scheme, to the element: the router
runs in fp32, the top-k gates are renormalised (+1e-9), each batch row is a
group, and a (token, slot) takes the rank of its place in the token-major,
slot-minor order among the routes of the group to the same expert; a route
whose rank is >= the capacity C is dropped. The reference builds that
assignment as a (G, S, K, E, C) one-hot and dispatches and combines with
einsums over it; at deepseek-v2-lite's width with batch 8 x 1024 that one-hot
alone is 377 M elements a layer. The port computes the same ranks with a
cumsum over (G, S*K, E) and moves the rows by index: each kept route names
its slot (e, g, rank) of an (E, G*C, D) buffer, the buffer is a gather of the
tokens, and a token's output is the gate-weighted sum of the K rows its
routes name (a dropped route names a zero row). The expert products are
batched matrix products over E (`torch.bmm`), as the reference's einsums
are plain products outside any Pallas kernel.

The load-balancing aux `E * sum_e f_e * p_e` is a product of two batch
means, which does not average over a batch split. Inside a sharded step's
loss (`utils.distributed.dp_context`, each rank on its slice of the batch)
both means are reduced over the data-parallel group before their product:
f_e (the dispatch fraction, no gradient) by an all-reduce mean, p_e (the
mean router probability) by `distributed.dp_mean`, whose backward leaves
each rank its own rows' term for the gradient average. So every rank holds
the whole batch's aux, as the reference's GSPMD means over the global batch
give it. Outside one, nothing is reduced.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import _act, cdtype
from repro_torch.utils import distributed

Params = Mapping[str, torch.Tensor]


def moe_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The router and the stacked expert weights: (E, d, f) / (E, f, d)."""
    d, f, e = cfg.d_model, cfg.moe.expert_d_ff, cfg.moe.n_experts
    return {"router": (d, e), "we_in": (e, d, f), "we_gate": (e, d, f), "we_out": (e, f, d)}


def shared_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The shared experts, one gated MLP of width expert_d_ff * n_shared."""
    d, fs = cfg.d_model, cfg.moe.expert_d_ff * cfg.moe.n_shared_experts
    return {"wi": (d, fs), "wg": (d, fs), "wo_mlp": (fs, d)}


def _capacity(moe: MoEConfig, group_size: int) -> int:
    c = int(group_size * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(moe.top_k, min(group_size, (c + 3) // 4 * 4))  # pad to multiple of 4


def route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """The router in fp32: (probs (G,S,E), renormalised top-k gates (G,S,K),
    their experts (G,S,K))."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def assign(gate_idx: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    """Each (token, slot)'s rank in its expert's buffer of its group: the
    count of the group's earlier routes to the same expert, token-major and
    slot-minor. gate_idx (G,S,K) -> ranks (G,S,K); rank >= capacity drops."""
    g, s, k = gate_idx.shape
    flat = gate_idx.reshape(g, s * k)
    onehot = F.one_hot(flat, n_experts)                           # (G, S*K, E)
    before = onehot.cumsum(dim=1) - onehot
    return before.gather(-1, flat[..., None]).reshape(g, s, k)


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Group == batch row. `params` holds
    router/we_in/we_gate/we_out and, with shared experts, "shared"
    (wi/wg/wo_mlp)."""
    moe = cfg.moe
    dt = cdtype(cfg)
    B, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    C = _capacity(moe, S)

    probs, gate_vals, gate_idx = route(params["router"], x, cfg)
    rank = assign(gate_idx, E, C)
    keep = rank < C
    # slot of each route in the (E, B, C) buffer; the dropped ones name the
    # zero row after it
    group = torch.arange(B, device=x.device)[:, None, None]
    slot = torch.where(keep, (gate_idx * B + group) * C + rank, E * B * C).reshape(-1)
    token = torch.arange(B * S, device=x.device).repeat_interleave(K)
    # the token each slot holds (the zero row B*S where it holds none)
    holder = torch.full((E * B * C + 1,), B * S, dtype=torch.long, device=x.device)
    holder[slot] = token
    x_rows = torch.cat([x.reshape(B * S, D).to(dt), x.new_zeros((1, D), dtype=dt)])
    xe = x_rows[holder[:-1]].reshape(E, B * C, D)

    h = _act(torch.bmm(xe, params["we_in"].to(dt)), cfg.act)
    h = h * torch.bmm(xe, params["we_gate"].to(dt))
    ye = torch.bmm(h, params["we_out"].to(dt))                    # (E, B*C, D)
    ye_rows = torch.cat([ye.reshape(E * B * C, D), ye.new_zeros((1, D))])
    picked = ye_rows[slot].reshape(B * S, K, D)
    y = (picked * gate_vals.to(dt).reshape(B * S, K, 1)).sum(dim=1).reshape(B, S, D)

    if "shared" in params:
        sp = params["shared"]
        hs = _act(x @ sp["wi"].to(dt), cfg.act) * (x @ sp["wg"].to(dt))
        y = y + hs @ sp["wo_mlp"].to(dt)

    # load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, gate_idx.reshape(-1), torch.ones(B * S * K, dtype=torch.float32, device=x.device))
    assign_frac = counts / (B * S)
    mean_prob = probs.mean(dim=(0, 1))
    dp = distributed.current_dp()
    if dp is not None:
        # the whole batch's means (see the module docstring)
        assign_frac = distributed.dp_mean(assign_frac, *dp, differentiable=False)
        mean_prob = distributed.dp_mean(mean_prob, *dp)
    aux = moe.router_aux_weight * E * (assign_frac / K * mean_prob).sum()
    return y.to(x.dtype), aux
