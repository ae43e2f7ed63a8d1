"""FusedExecutor, Form A: one step function per training iteration
(counterpart of `repro.engine.fused`).

Two switches choose the weight-space path, resolved as the reference
resolves them:
* `fused_update`: the flat-buffer kernels (perturb, optimizer epilogue,
  ascent refresh). None takes the port's default: on for a step on one
  device (no mesh, or a mesh of 1 device; the kernels on the card, their
  plain versions on the CPU), off on a larger mesh, where flattening a
  sharded leaf into a bucket would gather it whole. False runs the
  reference's per-leaf compositions and optimizer chain.
* `resident`: bucket-resident state (parameters, moments and the ascent
  state as flat buffers updated in place, `utils.buckets`). None follows the
  resolved `fused_update` when the whole chain qualifies: an unsharded step,
  a RESIDENT_METHODS method with the lossless ascent exchange and an
  optimizer the fused path recognizes (`optim.sgd` / `optim.adamw` without a
  decay mask). Resident state on a mesh of more than 1 device raises.
The default, and the path of the card, is fused and resident.

With `mesh` (a `launch.mesh.Mesh`, and then `model_cfg` for the sharding
rules) of more than one rank, the state is stored sharded: every leaf a
DTensor placed by `launch.sharding.state_spec_tree` (ZeRO-3 storage), each
rank holding 1/N of a leaf that the rules shard over N devices. The step
computes in the reference's mesh layout (`api.mesh_context`,
`models.partitioning`):
  * each rank runs the model on its slice of the batch over the dp axes
    (the ascent slice too); a leading dim the dp axes do not divide is not
    split, as `batch_spec_tree` drops it. The batch may come whole on every
    rank (the pipeline's) or placed by `batch_spec_tree` (DTensor leaves:
    each rank's rows are its local shard; microbatch i is the global chunk
    i, placed the same way);
  * the weights are gathered one layer at a time where the layer runs
    (`partitioning.gather_block`, differentiable): over the dp axes only
    where tensor-parallel code consumes the rank's "model" shard (the "tp"
    profile's attention heads, MLP and vocabulary: the ranks along "model"
    split that compute, Megatron-style), whole elsewhere;
  * under the "fsdp_sp" profile each rank of the model group computes its
    block of the sequence (`partitioning.sequence_block`, installed by the
    model's forward on the whole token rows, so a microbatch is cut as the
    batch is); its loss is its share of the global masked mean
    (`registry.sequence_parallel_cross_entropy`), and every weight's
    gradient is summed over the model group;
  * the loss (and each scalar aux) is the mean over the dp group, and each
    weight's gradient is averaged over the dp group (summed over the model
    group where each model rank used a part of a whole weight) and cut to
    its shard;
  * the per-leaf weight-space path (perturbation, ascent refresh, optimizer
    chain) runs on the DTensor leaves, elementwise on each shard; its norms
    and dots reduce in one all-reduce over the flattened mesh, so every rank
    sees the same bits (`utils.trees`).
The numbers are the unsharded step's up to summation order. The logits of a
vocab-sharded head stay sharded (`registry.vocab_parallel_cross_entropy`),
and a sequence block's stay the block's; for a method that reads
aux["logits"] (MESA) they are gathered over the vocabulary only, and its
mean over the positions (aux["position_mean"]) is reduced over the ranks
that hold the dp rows and the blocks, so that the KL term is the whole
batch's on every rank. A loss
term whose per-row parts do not average (a MoE's load-balancing aux, a product of two batch means)
reads the dp group from `distributed.dp_context`, which the sharded loss
installs around the model's loss function, and reduces its means over the
group first: it is the whole batch's value, as the reference's. A rank
outside a smaller mesh (after a shrink) holds empty shards, skips the
compute, keeps its step count and takes the step's metrics from rank 0, so
every rank reports the same numbers and can rejoin on a grow (`resize`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch

from repro_torch.core import Method, MethodConfig, TrainState, init_train_state, make_method
from repro_torch.core.api import LossFn, params_device
from repro_torch.core.async_sam import AsyncSamState
from repro_torch.engine.api import ensure_metric_contract, scalar_metrics
from repro_torch.optim import GradientTransform, configure_fused
from repro_torch.utils import distributed, trees

# Methods whose steps are weight-space + value_and_grad compositions, kept on
# bucket-resident state (the reference's list). The others (looksam, esam,
# aesam, mesa) keep per-leaf state, as in the reference; with fused_update on
# their weight-space passes still run the flat-buffer kernels, each call
# gathering its operands into buckets.
RESIDENT_METHODS = ("sgd", "sam", "gsam", "async_sam")


class FusedExecutor:
    """Single-resource executor: the whole step runs on the params' device,
    or data-parallel on sharded state over `mesh`.

    Args:
      loss_fn: framework loss callback `(params, batch, gen) -> (loss, aux)`.
      method: a `MethodConfig` (name-dispatched) or an already-built `Method`.
      optimizer: a `GradientTransform` (`optim.sgd`, `optim.adamw`, or a
        hand-built chain, which runs per-leaf).
      mesh: a `launch.mesh.Mesh`; None (or a 1-device mesh) is the
        single-device step.
      model_cfg: the ModelConfig the sharding rules read; needed with `mesh`.
      fused_update, resident: see the module docstring.
    """

    name = "fused"

    def __init__(self, loss_fn: LossFn,
                 method: Union[Method, MethodConfig, None] = None,
                 optimizer: Optional[GradientTransform] = None, *,
                 mesh=None, model_cfg=None,
                 fused_update: Optional[bool] = None,
                 resident: Optional[bool] = None):
        if optimizer is None:
            raise ValueError("FusedExecutor needs an optimizer")
        unsharded = mesh is None or mesh.size == 1
        if fused_update is None:
            fused_update = unsharded
        optimizer = configure_fused(optimizer, fused_update)
        if isinstance(method, Method):
            # rebuild from its config so the step sees the resolved flag; a
            # hand-constructed Method without one is taken as it is
            if method.cfg is not None and method.cfg.fused_update != fused_update:
                method = make_method(dataclasses.replace(method.cfg, fused_update=fused_update))
            self.method = method
        else:
            self.method = make_method(dataclasses.replace(method or MethodConfig(),
                                                          fused_update=fused_update))
        if resident is None:
            mcfg = self.method.cfg
            resident = (fused_update and unsharded and self.method.name in RESIDENT_METHODS
                        and optimizer.fused_spec is not None
                        and (mcfg is None or mcfg.compressor == "none"))
        if resident and not unsharded:
            # flattening a model-sharded leaf into a global bucket would
            # gather it whole; a sharded mesh keeps the per-leaf state
            raise ValueError("bucket-resident state needs an unsharded step "
                             f"(mesh size {mesh.size}); use resident=False or "
                             "drop the mesh")
        if resident and optimizer.fused_spec is None:
            raise ValueError("bucket-resident state needs an optimizer the fused path "
                             "recognizes (optim.sgd / optim.adamw without a decay mask); "
                             "use resident=False")
        if mesh is not None and model_cfg is None:
            raise ValueError("mesh sharding needs the ModelConfig (model_cfg=...)")
        self.fused_update = bool(fused_update)
        self.resident = bool(resident)
        self.optimizer = optimizer
        self.mesh = mesh
        self.model_cfg = model_cfg
        self._loss_fn = loss_fn
        self._step = self._make_step()
        self._closed = False

    @property
    def sharded(self) -> bool:
        """Whether the state lies sharded over a mesh of ranks."""
        return self.mesh is not None and self.mesh.sharded

    def _make_step(self):
        """The method's step, built afresh (its workspace is tied to the
        state's placement), on the data-parallel loss when sharded."""
        if not self.sharded:
            return self.method.make_step(self._loss_fn, self.optimizer)
        # MESA reads aux["logits"] over the whole vocabulary
        vocab = self.model_cfg.vocab_size if self.method.name == "mesa" else None
        loss_fn = _dp_loss(self._loss_fn, self.mesh, whole_vocab=vocab)
        return self.method.make_step(loss_fn, self.optimizer)

    def init_state(self, params, seed: int = 0) -> TrainState:
        """`params`: the model, a mapping of name -> tensor, or a
        BucketedState. Resident, the model's parameters become views into the
        state's buffers; per-leaf, the state holds their tensors. Either way
        the model reads what the steps write. On a sharded mesh the state is
        then placed by the rules (the model keeps its own tensors)."""
        state = init_train_state(params, self.optimizer, self.method, seed,
                                 resident=self.resident)
        if self.sharded:
            from repro_torch.runtime.elastic import reshard_state
            state = reshard_state(state, self.model_cfg, self.mesh)
        return state

    def abstract_state(self, params_fn, seed: int = 0) -> TrainState:
        """The step-0 state with no data (the dry run's entry): `params_fn()`
        (the model, e.g. `lambda: bundle.init(device=...)`) and `init_state`
        run under a fresh `FakeTensorMode`, so a full-size state costs
        nothing and nothing is allocated on a device. It is placed as the
        live state is: bucket-resident on no mesh or a 1-device mesh (the
        buffers the step updates), DTensors placed by the sharding rules on
        a sharded mesh."""
        from repro_torch.utils import abstract
        with abstract.fake_mode():
            return self.init_state(params_fn(), seed)

    def lower(self, state: TrainState, batch: dict):
        """One step traced on `state` and `batch` (fake tensors, e.g. from
        `abstract_state` and `models.registry.batch_spec`, or real ones) by a
        step built afresh, so the executor's own step and its buffers are
        untouched: the port's lowered step, a `utils.abstract.Lowered`
        (ops, flops, collectives, kernels, this rank's argument, output and
        peak bytes). On a sharded mesh this is this rank's step, its
        gathers and all-reduces included."""
        from repro_torch.utils import abstract
        if self.sharded and not self.mesh.is_member:
            raise ValueError("this rank lies outside the mesh: it traces no step")
        _, lowered = abstract.trace(self._make_step(), state, batch)
        return lowered

    def resize(self, state: TrainState, new_mesh) -> TrainState:
        """Elastic re-entry: re-place the live `state` onto `new_mesh` and
        rebuild the step against it.

        Bucket-resident state stays resident: its layout is
        mesh-independent and the target must be unsharded, as at
        construction; the buffers stay where they are (moved only to another
        device) and `self.mesh` becomes None (a 1-device mesh adds nothing).
        Per-leaf state re-places leaf by sharding rule, rank to rank
        (`runtime.elastic.reshard_state`; None: every rank holds it whole).
        """
        if self._closed:
            raise RuntimeError("executor is closed")
        from repro_torch.runtime.elastic import reshard_state
        if self.resident:
            if new_mesh is not None and new_mesh.size > 1:
                raise ValueError(
                    "bucket-resident step cannot resize onto a sharded mesh "
                    f"(size {new_mesh.size}); per-shard bucketing is the "
                    "reference's follow-on — rebuild with resident=False to "
                    "resize across sharded meshes")
            state = reshard_state(state, self.model_cfg, new_mesh)
            self.mesh = None
            return state
        if new_mesh is not None and self.model_cfg is None:
            raise ValueError("resize onto a mesh needs the ModelConfig "
                             "(construct the executor with model_cfg=...)")
        state = reshard_state(state, self.model_cfg, new_mesh)
        self.mesh = new_mesh
        self._step = self._make_step()
        return state

    def step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """One step; on the card it ends in a synchronize, so the host-side
        timing (ThroughputMeter, the Engine's step_time_s) sees the step's
        latency, as the reference's block on the new params does. The
        tracker's `train_step` span around it is host time too: it covers the
        device's work only through that synchronize, which is the step's
        own; no span adds one."""
        if self._closed:
            raise RuntimeError("executor is closed")
        if self.sharded and not self.mesh.is_member:
            # outside the mesh: nothing to compute; keep the step count
            state, metrics = state._replace(step=state.step + 1), {}
        else:
            state, metrics = self._step(state, batch)
            dev = params_device(state.params)
            if dev.type == "cuda":
                # host-side timing and callbacks see the step's real latency
                # (the reference blocks on the new params)
                torch.cuda.synchronize(dev)
            ms = state.method_state
            tau = ms.staleness if isinstance(ms, AsyncSamState) else 0
            metrics = ensure_metric_contract(
                metrics, tau=tau, perturbed=0.0 if self.method.name == "sgd" else 1.0)
        if self.sharded and self.mesh.size < distributed.world_size():
            # every rank reports rank 0's numbers (the ranks outside the mesh
            # computed none)
            metrics = distributed.broadcast_object(scalar_metrics(metrics))
        return state, metrics

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _dp_loss(loss_fn: LossFn, mesh, whole_vocab: Optional[int] = None) -> LossFn:
    """`loss_fn` over `mesh`: this rank's slice of the batch over the dp
    axes, run inside the mesh's layout and the dp group's `dp_context` on
    the sharded weights (a model bundle's loss gathers them layer by layer;
    any other loss function gets them gathered whole); the loss
    and the scalar aux averaged over the dp group (see the module
    docstring). `whole_vocab`: aux["logits"] of a vocab-sharded head
    gathered to that many entries over "model", and aux["position_mean"]
    the mean over the whole batch's positions of a function of them
    (`distributed.global_mean`: the dp rows and the sequence blocks stay
    on their ranks)."""
    from repro_torch.engine.api import mesh_context
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.models import partitioning

    from repro_torch.models.registry import ModelBundle

    dm, names = mesh.device_mesh, tuple(mesh.axis_names)
    dp_dims = [names.index(a) for a in dp_axes(mesh)]
    _, dp_groups = distributed.mesh_groups(dm)
    per_layer = isinstance(getattr(loss_fn, "__self__", None), ModelBundle)

    def fn(params, batch, gen):
        coord = dm.get_coordinate()
        group = dp_groups[coord[names.index("model")] if "model" in names else 0]
        idx, n = distributed.dp_index(dm, dp_dims)
        rows = [x.shape[0] for x in trees.tree_leaves(batch) if x.dim()]
        split = n > 1 and bool(rows) and all(r % n == 0 for r in rows)
        if split:
            batch = trees.tree_map(
                lambda x: distributed.dp_rows(x, dp_dims, idx, n) if x.dim() else x, batch)
        else:
            batch = trees.tree_map(distributed.gather, batch)
        n_eff = n if split else 1
        with mesh_context(mesh), distributed.dp_context((group, n_eff)):
            if not per_layer:
                params = {k: partitioning.gather_leaf(v) for k, v in params.items()}
            loss, aux = loss_fn(params, batch, gen)
            logits = aux.get("logits")
            if whole_vocab is not None and isinstance(logits, torch.Tensor) and logits.dim():
                lay = partitioning.current_layout()
                if logits.shape[-1] != whole_vocab:
                    logits = distributed.gather_from_model(logits, lay.model_group, lay.m, lay.r)
                # the positions stay on their dp rows and sequence blocks; a
                # mean over them is reduced over the ranks that hold them
                blocks = ("tokens" in batch and logits.dim() == 3
                          and logits.shape[1] != batch["tokens"].shape[1])
                over = ((lay.flat_group if n_eff > 1 else lay.model_group) if blocks
                        else group if n_eff > 1 else None)
                aux = {**aux, "logits": logits, "position_mean": functools.partial(
                    distributed.global_mean, group=over, n=n_eff)}
        if n_eff > 1:
            loss = distributed.dp_mean(loss, group, n_eff)
            aux = {k: (distributed.dp_mean(v, group, n_eff, differentiable=False)
                       if isinstance(v, torch.Tensor) and v.dim() == 0
                       and v.is_floating_point() else v)
                   for k, v in aux.items()}
        return loss, aux

    return fn
