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

Under the tensor-parallel layout (`partitioning.tp_layout`) each rank of
the model group is handed its share of the experts as the rules place them
over "model" (`partitioning.gather_part`): EP's E/m experts where m divides
E, else expert TP's f/m columns of every expert. Every rank routes the same
tokens (x after Megatron's f, `distributed.copy_to_model`) with the same
gathered router, so the routing is the same bits on every rank; each
computes its share of y (`moe_share`) and, on their d_ff shard, the shared
experts' part, and one all-reduce over the group sums them
(`distributed.reduce_from_model`). The router's gradient is then partial
(each rank combines its own share), and its leaf's gradient is summed over
the group; the aux, which every rank computes whole, is differentiated at
1/m on each rank (`distributed.scale_grad`), so that the sum counts it once.

Under a sequence block (`partitioning.seq_block`: the "fsdp_sp" profile,
whole weights) a row is still one group: the capacity is the whole row's,
each route's rank adds the row's earlier blocks' counts for its expert
(`make_routing`: the model group's (B, E) counts gathered), so the blocks
drop exactly the routes the whole row drops, and each rank's buffer holds
its block's routes; the aux's counts and mean probabilities are summed
over the blocks before their product (`aux_loss`).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import partitioning
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


def expert_counts(gate_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each group's routes to each expert: gate_idx (G,S,K) -> (G,E)."""
    return F.one_hot(gate_idx.reshape(gate_idx.shape[0], -1), n_experts).sum(dim=1)


def block_ranks(gate_idx: torch.Tensor, ranks: torch.Tensor, counts: torch.Tensor, r: int
                ) -> torch.Tensor:
    """The ranks in the whole row's buffers of sequence block r's routes:
    their ranks among the block's own (`assign` of the block) plus the
    routes to the same expert in the row's earlier blocks, counts (m,G,E)
    every block's `expert_counts`."""
    g = gate_idx.shape[0]
    before = counts[:r].sum(dim=0)
    return ranks + before.gather(-1, gate_idx.reshape(g, -1)).reshape(ranks.shape)


class Routing(NamedTuple):
    """The router's decisions for x (B, S, D), computed whole (every model
    rank computes them from the same bits): probs (B,S,E) in fp32, the
    renormalised top-k gates and their experts (B,S,K), each route's rank
    in its expert's buffer of its row (B,S,K), a rank >= the capacity
    dropping it, and its slot in this rank's buffer (B,S,K): the rank
    itself, or under a sequence block its rank among the block's routes."""
    probs: torch.Tensor
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    rank: torch.Tensor
    slot: torch.Tensor


def _row_len(s: int) -> int:
    """The tokens of a group (a batch row) of which x holds s: the row's
    whole length under a sequence block (`partitioning.seq_block`, each of
    the m ranks holding s), else s."""
    lay = partitioning.current_layout() if partitioning.seq_block() is not None else None
    return s if lay is None else s * lay.m


def routing_of(probs: torch.Tensor, gate_vals: torch.Tensor, gate_idx: torch.Tensor,
               cfg: ModelConfig, row_len: int, counts: Optional[torch.Tensor] = None,
               r: int = 0) -> Routing:
    """The Routing of `route`'s decisions for rows of `row_len` tokens (the
    capacity's): each route's slot its rank among x's own routes, and its
    rank that, or for sequence block r of the rows (counts (m,G,E), every
    block's `expert_counts`) `block_ranks`'."""
    slot = assign(gate_idx, cfg.moe.n_experts, _capacity(cfg.moe, row_len))
    rank = slot if counts is None else block_ranks(gate_idx, slot, counts, r)
    return Routing(probs, gate_vals, gate_idx, rank, slot)


def make_routing(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The routing of x. Under a sequence block each route's rank counts
    the routes of its row's earlier blocks to the same expert (the model
    group's per-row, per-expert counts gathered): the whole row's
    `assign`, so the capacity drops the same routes."""
    probs, gate_vals, gate_idx = route(router, x, cfg)
    if partitioning.seq_block() is None:
        return routing_of(probs, gate_vals, gate_idx, cfg, x.shape[1])
    lay = partitioning.current_layout()
    counts = distributed.gather_stack(expert_counts(gate_idx, cfg.moe.n_experts), lay)
    return routing_of(probs, gate_vals, gate_idx, cfg, x.shape[1] * lay.m, counts, lay.r)


def moe_share(params: Params, x: torch.Tensor, cfg: ModelConfig, r: int = 0, m: int = 1,
              routing: Optional[Routing] = None) -> torch.Tensor:
    """Rank r of m's share of the routed experts' output (B, S, D), in the
    compute dtype, from `params`' router and this rank's share of the
    expert weights (`expert_share`): under EP (we_* hold E/m experts) the
    gate-weighted rows of experts [r E/m, (r+1) E/m), its buffer (E/m,
    B*C, D) built from their slots only; under expert TP (every expert on
    f/m columns of we_in / we_gate and the rows of we_out) every route's
    partial row. The activation is elementwise, so the shares of r = 0 ..
    m-1 sum to the whole (m 1). `routing` is `make_routing`'s, computed
    here when None. Under a sequence block the capacity C is the whole
    row's and the buffer holds the block's routes, min(C, S) a row and
    expert."""
    moe = cfg.moe
    dt = cdtype(cfg)
    B, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    C = _capacity(moe, _row_len(S))
    width = min(C, S)
    rt = make_routing(params["router"], x, cfg) if routing is None else routing
    e_loc = params["we_in"].shape[0]
    if e_loc != E and e_loc * m != E:
        raise ValueError(f"{e_loc} experts a rank do not split {E} over {m} ranks")
    lo = r * e_loc if e_loc != E else 0
    mine = (rt.rank < C) & (rt.gate_idx >= lo) & (rt.gate_idx < lo + e_loc)
    # slot of each of this share's routes in the (E_loc, B, width) buffer;
    # the others name the zero row after it
    group = torch.arange(B, device=x.device)[:, None, None]
    slot = torch.where(mine, ((rt.gate_idx - lo) * B + group) * width + rt.slot,
                       e_loc * B * width).reshape(-1)
    token = torch.arange(B * S, device=x.device).repeat_interleave(K)
    # the token each slot holds (the zero row B*S where it holds none)
    holder = torch.full((e_loc * B * width + 1,), B * S, dtype=torch.long, device=x.device)
    holder[slot] = token
    x_rows = torch.cat([x.reshape(B * S, D).to(dt), x.new_zeros((1, D), dtype=dt)])
    xe = x_rows[holder[:-1]].reshape(e_loc, B * width, D)

    h = _act(torch.bmm(xe, params["we_in"].to(dt)), cfg.act)
    h = h * torch.bmm(xe, params["we_gate"].to(dt))
    ye = torch.bmm(h, params["we_out"].to(dt))                    # (E_loc, B*width, D)
    ye_rows = torch.cat([ye.reshape(e_loc * B * width, D), ye.new_zeros((1, D))])
    picked = ye_rows[slot].reshape(B * S, K, D)
    return (picked * rt.gate_vals.to(dt).reshape(B * S, K, 1)).sum(dim=1).reshape(B, S, D)


def shared_apply(sp: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The shared experts (a gated MLP), on whole weights or this rank's
    d_ff columns of wi / wg and rows of wo_mlp (a partial sum)."""
    dt = cdtype(cfg)
    hs = _act(x @ sp["wi"].to(dt), cfg.act) * (x @ sp["wg"].to(dt))
    return hs @ sp["wo_mlp"].to(dt)


def expert_share(params: Params, cfg: ModelConfig, r: int, m: int) -> dict:
    """Rank r of m's share of whole MoE weights, as `param_partition_spec`
    places them over "model" (views, so gradients reach the whole): EP's
    experts [r E/m, (r+1) E/m) where m divides E, else expert TP's f/m
    columns of we_in / we_gate and rows of we_out; the shared experts' d_ff
    columns and rows where m divides it; the router whole."""
    E, f = cfg.moe.n_experts, cfg.moe.expert_d_ff

    def cut(t, dim, n):
        w = n // m
        return t.narrow(dim, r * w, w)

    out = {"router": params["router"]}
    if E % m == 0:
        out.update({name: cut(params[name], 0, E) for name in ("we_in", "we_gate", "we_out")})
    else:
        out.update(we_in=cut(params["we_in"], 2, f), we_gate=cut(params["we_gate"], 2, f),
                   we_out=cut(params["we_out"], 1, f))
    if "shared" in params:
        sp = params["shared"]
        fs = sp["wi"].shape[-1]
        out["shared"] = sp if fs % m else {"wi": cut(sp["wi"], 1, fs), "wg": cut(sp["wg"], 1, fs),
                                           "wo_mlp": cut(sp["wo_mlp"], 0, fs)}
    return out


def aux_shares(rt: Routing, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """rt's shares (E,) of the aux's route fractions and mean probabilities
    over n tokens: its routes to each expert and its probabilities' sums,
    each over n."""
    E = rt.probs.shape[-1]
    device = rt.gate_idx.device
    counts = torch.zeros(E, dtype=torch.float32, device=device).index_add_(
        0, rt.gate_idx.reshape(-1),
        torch.ones(rt.gate_idx.numel(), dtype=torch.float32, device=device))
    return counts / n, rt.probs.sum(dim=(0, 1)) / n


def aux_value(assign_frac: torch.Tensor, mean_prob: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """The aux of the route fractions f_e and mean probabilities p_e:
    weight * E * sum_e f_e / K * p_e."""
    moe = cfg.moe
    return moe.router_aux_weight * moe.n_experts * (assign_frac / moe.top_k * mean_prob).sum()


def aux_loss(rt: Routing, cfg: ModelConfig) -> torch.Tensor:
    """The load-balancing aux (Switch-style) E * sum_e f_e * p_e, its means
    over the whole batch inside a sharded step's loss (see the module
    docstring): under a sequence block over every block of the rows, each
    block's shares (`aux_shares`) summed over the model group
    (`distributed.group_sum`: each rank differentiates its own)."""
    B, S = rt.gate_idx.shape[:2]
    assign_frac, mean_prob = aux_shares(rt, B * _row_len(S))
    if partitioning.seq_block() is not None:
        group = partitioning.current_layout().model_group
        assign_frac = distributed.group_sum(assign_frac, group)
        mean_prob = distributed.group_sum(mean_prob, group)
    dp = distributed.current_dp()
    if dp is not None:
        assign_frac = distributed.dp_mean(assign_frac, *dp, differentiable=False)
        mean_prob = distributed.dp_mean(mean_prob, *dp)
    return aux_value(assign_frac, mean_prob, cfg)


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Group == batch row. `params` holds
    router/we_in/we_gate/we_out and, with shared experts, "shared"
    (wi/wg/wo_mlp): whole, or under the tensor-parallel layout this rank's
    shares (see the module docstring)."""
    moe = cfg.moe
    e_in = params["we_in"].shape
    split = e_in[0] != moe.n_experts or e_in[-1] != moe.expert_d_ff
    shared = params.get("shared")
    shared_split = (shared is not None
                    and shared["wi"].shape[-1] != moe.expert_d_ff * moe.n_shared_experts)
    lay = partitioning.tp_layout(cfg) if split or shared_split else None
    xm = x if lay is None else distributed.copy_to_model(x, lay.model_group)
    xe = xm if split else x
    rt = make_routing(params["router"], xe, cfg)
    y = moe_share(params, xe, cfg, *((lay.r, lay.m) if split else (0, 1)), routing=rt)
    aux = aux_loss(rt, cfg)
    local = None
    if split:
        local, y = y, 0
        # every model rank computes the aux whole: each differentiates 1/m
        # of it, so that the model group's sum counts it once
        aux = distributed.scale_grad(aux, 1.0 / lay.m)
    if shared is not None:
        ys = shared_apply(shared, xm if shared_split else x, cfg)
        if shared_split:
            local = ys if local is None else local + ys
        else:
            y = y + ys
    if local is not None:
        y = y + distributed.reduce_from_model(local, lay.model_group)
    return y.to(x.dtype), aux
