"""Step builders: the train step of the SAM family and the serve steps
(prefill/decode) (counterpart of `repro.launch.steps`).

As in the reference this is a thin shim: training goes through
`repro_torch.engine` (`FusedExecutor` / `HeteroExecutor` + `Engine.fit`),
which owns the mesh, the placement of the state and the step's buffers;
`TrainSetup.fused_executor` bridges to it. The serve steps call the bundle's
prefill and decode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core import Method, MethodConfig, TrainState, init_train_state, make_method
from repro_torch.models.registry import ModelBundle
from repro_torch.optim import GradientTransform, make_optimizer

Tree = Any


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    bundle: ModelBundle
    method: Method
    method_cfg: MethodConfig
    optimizer: GradientTransform
    step_fn: Callable[[TrainState, dict], tuple[TrainState, dict]]

    def init_state(self, params, seed: int = 0) -> TrainState:
        """The step-0 state (`core.init_train_state`: bucket-resident when
        the optimizer has a FusedSpec, else per-leaf)."""
        return init_train_state(params, self.optimizer, self.method, seed,
                                resident=self.optimizer.fused_spec is not None)

    def fused_executor(self, *, mesh=None, model_cfg=None):
        """Bridge to the Engine API: the same pieces as an executor."""
        from repro_torch.engine import FusedExecutor
        return FusedExecutor(self.bundle.loss_fn, self.method, self.optimizer,
                             mesh=mesh, model_cfg=model_cfg)


def make_train_setup(bundle: ModelBundle,
                     method_cfg: Optional[MethodConfig] = None,
                     optimizer: Optional[GradientTransform] = None,
                     lr: float = 1e-3) -> TrainSetup:
    method_cfg = method_cfg or MethodConfig()
    method = make_method(method_cfg)
    optimizer = optimizer or make_optimizer("adamw", lr)
    step_fn = method.make_step(bundle.loss_fn, optimizer)
    return TrainSetup(bundle=bundle, method=method, method_cfg=method_cfg,
                      optimizer=optimizer, step_fn=step_fn)


def make_prefill_step(bundle: ModelBundle, mesh=None, pad_to: int = 0) -> Callable:
    """prefill_step(params, batch) -> (logits, cache), the cache of length
    max(S, pad_to) (the bundle's prefill). On a sharded `mesh` (a
    `launch.mesh.Mesh`) the sharded serve step: see `_dp_serve`."""
    def prefill_step(params, batch: dict):
        return bundle.prefill(params, batch, pad_to=pad_to)

    if mesh is None or not mesh.sharded:
        return prefill_step
    serve = _dp_serve(lambda p, c, b: prefill_step(p, b), bundle, mesh, pad_to)
    return lambda params, batch: serve(params, None, batch)


def make_decode_step(bundle: ModelBundle, mesh=None) -> Callable:
    """decode_step(params, cache, batch) -> (logits, cache), the cache updated
    in place. On a sharded `mesh` the sharded serve step (`_dp_serve`)."""
    def decode_step(params, cache, batch: dict):
        return bundle.decode(params, cache, batch)

    if mesh is None or not mesh.sharded:
        return decode_step
    return _dp_serve(decode_step, bundle, mesh)


def _dp_serve(step: Callable, bundle: ModelBundle, mesh, pad_to: int = 0) -> Callable:
    """A serve step on params, cache and batch placed over `mesh` (DTensors,
    by `state_spec_tree`, a cache by `serve_cache_spec_tree` or
    `cache_spec_tree`, a batch by `batch_spec_tree`), computed in the mesh's
    layout as the sharded train step is (`engine.fused`): this rank's rows
    of the batch over the dp axes when they divide it (else every row); the
    weights gathered layer by layer where the model runs them, attention
    (the encoder-decoder's self- and cross-attention too), MLP, MoE
    experts, rwkv6's time and channel mixes and the logits tensor-parallel
    over "model" under the "tp" profile; the cache as each rank computes
    on it (`compute_cache_spec_tree`: its rows, and where the model
    computes on its heads the k/v's, cross k/v's, rwkv6 wkv state's or
    mamba2 SSM state's heads and x-conv tail's channels; every other dim
    whole), which moves no byte when it comes in
    `serve_cache_spec_tree`'s placement; the new cache placed back as it
    came (prefill: by `serve_cache_spec_tree`, the cross k/v as long as
    the batch's encoder frames). Under the "fsdp_sp" profile, and under
    "tp" where the kv heads do not carry the cache (or it holds MLA's
    latents), k and v (the latents, the cross k/v) stay on their sequence
    blocks (`partitioning.cache_sequence`): prefill writes each rank's
    block from what it computed, decode combines the ranks' attention over
    theirs ("tp": every query head over each block, the rank's heads kept
    after). Under "fsdp_sp" each rank of the model group computes its
    block of the prompt's sequence (the encoder-decoder its blocks of the
    frames too), and the sampler's last-position logits, and rwkv6's and
    mamba2's states, come from the last block's rank, broadcast to its
    group (`transformer.prefill`, `encdec.prefill`).

    Returns step(params, cache, batch) -> (logits of this rank's rows over
    the whole vocabulary (a vocab-sharded head's gathered over "model"),
    the placed cache); prefill passes cache None."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.engine.api import mesh_context
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.sharding import (compute_cache_spec_tree, serve_cache_spec_tree,
                                             to_placements)
    from repro_torch.models import partitioning
    from repro_torch.utils import distributed, trees

    names = tuple(mesh.axis_names)
    dm = mesh.device_mesh
    dp_dims = [names.index(a) for a in dp_axes(mesh)]
    idx, n = distributed.dp_index(dm, dp_dims)
    cfg = bundle.cfg

    def localize(x, pl):
        if not distributed.is_dtensor(x):
            return x
        return x.redistribute(dm, pl).to_local()

    def place(x, pl, target):
        if not isinstance(x, torch.Tensor) or not x.dim():
            return x
        return DTensor.from_local(x, dm, pl, run_check=False).redistribute(dm, target)

    def serve(params, cache, batch: dict):
        rows = [x.shape[0] for x in trees.tree_leaves(batch) if x.dim()]
        split = n > 1 and bool(rows) and all(r % n == 0 for r in rows)
        with torch.no_grad(), mesh_context(mesh):
            if split:
                local_batch = {k: distributed.dp_rows(v, dp_dims, idx, n)
                               for k, v in batch.items()}
            else:
                local_batch = {k: distributed.gather(v) for k, v in batch.items()}
            if cache is not None:
                shapes, target = cache, _placements_of(cache)
            else:    # the prefill's cache at its global shape: pos S
                b, s = batch["tokens"].shape
                shapes = bundle.init_cache(b, max(s, pad_to), pos=s, device="meta")
                if "enc_frames" in batch:   # the cross k/v: one row an encoder frame
                    n_enc = batch["enc_frames"].shape[1]
                    shapes["layers"] = {k: t.new_empty((*t.shape[:2], n_enc, *t.shape[3:]))
                                        if k.startswith("cross_") else t
                                        for k, t in shapes["layers"].items()}
                target = to_placements(serve_cache_spec_tree(shapes, cfg, mesh), mesh)
            pl = to_placements(compute_cache_spec_tree(shapes, cfg, mesh, split), mesh)
            local_cache = None if cache is None else _zip(localize, cache, pl)
            with _cache_sequence(pl, dm):
                logits, new_cache = step(params, local_cache, local_batch)
            if logits.shape[-1] != cfg.vocab_size:
                lay = partitioning.current_layout()
                logits = distributed.gather_from_model(logits, lay.model_group, lay.m, lay.r)
            return logits, _zip(place, new_cache, pl, target)

    return serve


def _cache_sequence(pl: dict, dm):
    """`partitioning.cache_sequence` for a cache whose k/v (or MLA latent)
    placements `pl` shard the sequence (dim 2 of a stacked (L, B, S, K, hd)
    or (L, B, S, R) leaf) over some mesh dims, and the encoder-decoder's
    cross k/v (its `cross`) likewise: this rank's block index over them
    (the first outermost), their number of blocks, and the group that spans
    them (the model group, or the flattened mesh when the dp axes take
    part); a null context where no such leaf is split on its sequence."""
    import contextlib

    from repro_torch.models import partitioning

    def blocks(names):
        kv = next((sub[name] for sub in pl.values() if isinstance(sub, dict)
                   for name in names if name in sub), None)
        dims = [] if kv is None else [i for i, p in enumerate(kv) if p.is_shard(2)]
        if not dims:
            return 0, 1, None
        coord, shape = dm.get_coordinate(), dm.shape
        index, ways = 0, 1
        for i in dims:
            index, ways = index * shape[i] + coord[i], ways * shape[i]
        lay = partitioning.current_layout()
        if dims == [lay.model_dim]:
            return index, ways, lay.model_group
        if len(dims) == len(shape):
            return index, ways, lay.flat_group
        raise NotImplementedError(f"a cache sequence split over mesh dims {dims}")

    index, ways, group = blocks(("k", "c_kv"))
    cross = blocks(("cross_k",))
    if ways == 1 and cross[1] == 1:
        return contextlib.nullcontext()
    return partitioning.cache_sequence(index, ways, group, cross=cross)


def _placements_of(tree):
    """The placements of a tree of DTensors (its structure kept; host values
    as they are)."""
    from repro_torch.utils import distributed
    if isinstance(tree, dict):
        return {k: _placements_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_placements_of(v) for v in tree)
    return tree.placements if distributed.is_dtensor(tree) else None


def _zip(f, tree, *pls):
    """f(leaf, its entry of each pl) over a nested dict / list of tensors
    and host values, where each pl has the structure (a None entry: the
    leaf as it is)."""
    if isinstance(tree, dict):
        return {k: _zip(f, v, *(pl[k] for pl in pls)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip(f, v, *ps) for v, *ps in zip(tree, *pls))
    return tree if any(p is None for p in pls) else f(tree, *pls)
