"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on
abstract state (counterpart of `repro.launch.dryrun`).

For each cell this script
  1. starts a world of 256 ranks (16x16), or 512 (2x16x16, `--multi-pod`),
     on the `fake` process-group backend, this process rank 0
     (`launch.mesh.fake_world`), and builds the production mesh on it: a
     live `DeviceMesh`, so the step is the port's real sharded step, its
     gathers and all-reduces included;
  2. builds the state, batch and cache as fake tensors placed by the
     sharding rules (`FusedExecutor.abstract_state`; `state_spec_tree`,
     `batch_spec_tree` and `serve_cache_spec_tree` for the serve cells): nothing
     is allocated on a device, no collective moves a byte;
  3. traces rank 0's step once (`utils.abstract.trace`: the AsyncSAM train
     step through `FusedExecutor.lower`, or the sharded serve step of
     `launch.steps`), recording its ops, flops, collectives, kernels and
     live bytes;
  4. writes a JSON artifact with the reference's fields.

What the reference does in three stages (lower on ShapeDtypeStructs over
512 forced host devices, compile, read XLA's analyses and the HLO's
collectives), the port does by tracing: `lower_s` is the time to build the
abstract state and inputs, `compile_s` the time to trace the step (eager
PyTorch has no compile stage). `flops` and `bytes_accessed` come from the
trace (`engine.api.cost_analysis_dict`), `peak_memory_per_device`,
`argument_bytes` and `output_bytes` from its live storages on rank 0, and
the collective inventory from its `c10d` ops (no HLO text to read).

The sharded cells trace the port's step, which stores the state 1/N a rank
and computes in the reference's mesh layout (`engine.fused`,
`models.partitioning`): each layer's weights gathered where it runs; under
the "tp" profile attention (MLA and the encoder-decoder's self- and
cross-attention too) on the rank's heads, the MLP on its d_ff, the MoE
experts on the rank's share (EP's E/m experts, or expert TP's d_ff / m of
every expert), rwkv6's time mix on its heads and channel mix on its d_ff
(its wkv decode state on the heads) and the logits on its vocabulary,
with their all-reduces over "model", and a decode cache whose kv heads do
not divide "model" (or MLA's latents, or whisper's 6 heads on 16, its
cross k/v too) on its sequence blocks; under the "fsdp_sp" profile
(qwen2.5-32b, zamba2-1.2b) the rank's block of the sequence, k and v
gathered whole, the SSD state chained, a decode cache on its sequence
blocks. `--profile` traces an arch under the other profile (every family
computes in either: zamba2's mamba2 on its heads under "tp", rwkv6's wkv
state chained and the MoE dispatch at the whole row's places under
"fsdp_sp"). The collectives are the port's own (explicit gathers,
Megatron's f and g), not GSPMD's, so the two inventories still differ.
A record is one rank's step (`rank`, 0): under "fsdp_sp" rank 0 holds the
sequence's first block, whose causal attention sees the fewest keys (rank
r's block sees about (2r + 1) / (2m) of the pairs), so its flops are the
group's least; its memory and wire bytes are any rank's.

`--device cuda` (the default) traces the card's path with its kernels (the
kernels' `torch.library` ops and their fake shapes). `--device cpu` traces
it too, on fake CPU tensors (`kernels.flat.trace_kernels`): the plain
versions at production shapes would take hours.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b --both-meshes --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-1.2b --shape train_4k \
      --profile tp --device cpu

`--arch` without `--shape` runs every shape of the arch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import pathlib
import time
from typing import Optional

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import MethodConfig
from repro_torch.models import (SHAPES, batch_spec, build_model, cache_spec, decode_batch_spec,
                                shape_applicable)
from repro_torch.models.config import ModelConfig, ShapeSpec

ARTIFACT_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def input_specs(arch: str, shape_name: str = "train_4k",
                method_cfg: Optional[MethodConfig] = None, device: str = "cuda") -> dict:
    """Fake stand-ins for every model input of the given cell (made under the
    caller's FakeTensorMode)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    method_cfg = method_cfg or MethodConfig()
    if shape.kind == "train":
        return batch_spec(cfg, shape, ascent_fraction=method_cfg.ascent_fraction,
                          device=device)
    if shape.kind == "prefill":
        return batch_spec(cfg, shape, device=device)
    return decode_batch_spec(cfg, shape, device=device)


def _abstract_cache(cfg: ModelConfig, shape: ShapeSpec, device: str = "cuda") -> dict:
    """The decode cache at pos = seq_len - 1 (under the caller's
    FakeTensorMode)."""
    return cache_spec(cfg, shape, device=device)


# ---------------------------------------------------------------------------
# Collective inventory
# ---------------------------------------------------------------------------

def collective_inventory(lowered) -> list[dict]:
    """One record per traced collective: kind, result bytes, group size."""
    return [{"kind": r["kind"], "bytes": r["bytes"], "group": r["group"]}
            for r in lowered.collectives]


def collective_cost_bytes(inventory: list[dict]) -> float:
    """Per-chip bytes-on-the-wire estimate (ring algorithms), the
    reference's formulas."""
    total = 0.0
    for rec in inventory:
        b, n = rec["bytes"], max(2, rec["group"])
        ring = (n - 1) / n
        if rec["kind"] == "all-reduce":
            total += 2 * b * ring
        elif rec["kind"] == "all-gather":
            total += b * ring                      # result-sized, gathered in
        elif rec["kind"] == "reduce-scatter":
            total += b * (n - 1)                   # operand = result * n
        elif rec["kind"] == "all-to-all":
            total += b * ring
        else:                                      # collective-permute
            total += b
    return total


# ---------------------------------------------------------------------------
# One-cell dry run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str                  # ok | skipped | failed
    note: str = ""
    rank: int = 0                # the rank whose step is traced
    lower_s: float = 0.0         # building the abstract state and inputs
    compile_s: float = 0.0       # tracing the step
    flops: float = 0.0           # per-device traced flops
    bytes_accessed: float = 0.0  # per-device traced bytes (cost_analysis_dict)
    collective_bytes: float = 0.0
    peak_memory_per_device: float = 0.0
    n_collectives: int = 0
    output_bytes: float = 0.0
    argument_bytes: float = 0.0
    param_count: int = 0         # parameter elements (train cells)
    param_bytes: int = 0         # parameter tree bytes (train cells)
    inventory: list = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def place_tree(tree, spec_tree, mesh):
    """Every tensor leaf of `tree` (a nested dict / list of tensors and host
    values) placed on `mesh` by its PartitionSpec in `spec_tree`: a DTensor
    holding this rank's shard; a 0-d leaf or a host value as it is."""
    import torch

    from repro_torch.launch.sharding import to_placements
    from repro_torch.utils import distributed

    placements = to_placements(spec_tree, mesh)

    def go(x, pl):
        if isinstance(x, dict):
            return {k: go(v, pl[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v, p) for v, p in zip(x, pl))
        if isinstance(x, torch.Tensor) and x.dim():
            return distributed.place(x, mesh.device_mesh, pl)
        return x

    return go(tree, placements)


def train_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh, method_cfg: MethodConfig,
                 device: str = "cuda"):
    """(executor, abstract state, placed batch) of a train cell on the live
    `mesh`: the AsyncSAM FusedExecutor with AdamW at 1e-3, clip 1.0, its
    state from `abstract_state`, the batch of `batch_spec` placed by
    `batch_spec_tree`."""
    from repro_torch.engine import FusedExecutor
    from repro_torch.launch.sharding import batch_spec_tree
    from repro_torch.optim import make_optimizer
    from repro_torch.utils import abstract

    bundle = build_model(cfg)
    # the Engine's executor owns the placement and the step here (the same
    # path launch/train.py drives), not a local shim
    executor = FusedExecutor(bundle.loss_fn, method_cfg,
                             make_optimizer("adamw", 1e-3, clip_norm=1.0),
                             mesh=mesh, model_cfg=cfg)
    state = executor.abstract_state(lambda: bundle.init(seed=0, device=device), seed=1)
    with abstract.fake_mode_of(state):
        batch = batch_spec(cfg, shape, ascent_fraction=method_cfg.ascent_fraction,
                           device=device)
        batch = place_tree(batch, batch_spec_tree(batch, mesh), mesh)
    return executor, state, batch


def serve_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh, device: str = "cuda") -> tuple:
    """The serve step's arguments on the live `mesh`: (params, batch) for a
    prefill cell, (params, cache, batch) for a decode cell, each placed by
    its rules (`state_spec_tree`, `batch_spec_tree`; the cache as the serve
    step keeps it, `serve_cache_spec_tree`)."""
    from repro_torch.core.api import per_leaf
    from repro_torch.launch.sharding import (batch_spec_tree, serve_cache_spec_tree,
                                             state_spec_tree)
    from repro_torch.utils import abstract

    with abstract.fake_mode():
        params = per_leaf(build_model(cfg).init(seed=0, device=device))
        params = place_tree(params, state_spec_tree(params, cfg, mesh), mesh)
        if shape.kind == "prefill":
            batch = batch_spec(cfg, shape, device=device)
            args = (params,)
        else:
            cache = _abstract_cache(cfg, shape, device=device)
            batch = decode_batch_spec(cfg, shape, device=device)
            args = (params, place_tree(cache, serve_cache_spec_tree(cache, cfg, mesh), mesh))
        return args + (place_tree(batch, batch_spec_tree(batch, mesh), mesh),)


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, method_cfg: MethodConfig,
               device: str = "cuda", result: Optional["CellResult"] = None):
    """One cell's step on the live `mesh` traced on abstract inputs (with the
    kernels' ops traced on fake CPU tensors too, `kernels.flat.trace_kernels`):
    the `utils.abstract.Lowered`. Fills `result`'s timings and, for a train
    cell, its parameter count and bytes."""
    from repro_torch.kernels import flat
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.utils import abstract, trees

    result = result if result is not None else CellResult("", shape.name, "", "ok")
    t0 = time.time()
    with flat.trace_kernels():
        if shape.kind == "train":
            executor, state, batch = train_inputs(cfg, shape, mesh, method_cfg, device)
            result.param_count = trees.tree_size(state.params)
            result.param_bytes = trees.tree_bytes(state.params)
            result.lower_s = time.time() - t0
            t1 = time.time()
            lowered = executor.lower(state, batch)
        else:
            args = serve_inputs(cfg, shape, mesh, device)
            step = (make_prefill_step if shape.kind == "prefill"
                    else make_decode_step)(build_model(cfg), mesh)
            result.lower_s = time.time() - t0
            t1 = time.time()
            _, lowered = abstract.trace(step, *args)
    result.compile_s = time.time() - t1
    return lowered


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             method: str = "async_sam", method_cfg: Optional[MethodConfig] = None,
             save: bool = True, verbose: bool = True,
             cfg_override: Optional[ModelConfig] = None, tag: str = "",
             device: str = "cuda") -> CellResult:
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    result = CellResult(arch=arch, shape=shape_name, mesh=mesh_name, status="ok",
                        note=tag)

    ok, why = shape_applicable(cfg, shape)
    if not ok:
        result.status, result.note = "skipped", why
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: SKIP ({why})")
        if save:
            _save(result, tag)
        return result

    from repro_torch.engine import cost_analysis_dict
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    # default execution profile: AsyncSAM with b'/b=25% and 4 microbatches
    mcfg = method_cfg or MethodConfig(name=method, n_microbatches=4)
    # DTensor warns of every two-hop gather of a leaf sharded over two mesh
    # dims; the trace records them as collectives
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            lowered = lower_cell(cfg, shape, mesh, mcfg, device, result)
        cost = cost_analysis_dict(lowered)
        result.flops = float(cost.get("flops", 0.0))
        result.bytes_accessed = float(cost.get("bytes accessed", 0.0))
        result.peak_memory_per_device = float(lowered.peak_bytes)
        result.argument_bytes = float(lowered.argument_bytes)
        result.output_bytes = float(lowered.output_bytes)
        inv = collective_inventory(lowered)
        result.n_collectives = len(inv)
        result.collective_bytes = collective_cost_bytes(inv)
        # keep a compact inventory (ops by kind)
        agg: dict[str, list[float]] = {}
        for rec in inv:
            a = agg.setdefault(rec["kind"], [0, 0.0])
            a[0] += 1
            a[1] += rec["bytes"]
        result.inventory = [
            {"kind": k, "count": v[0], "result_bytes": v[1]}
            for k, v in sorted(agg.items())]

        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
                  f"(lower {result.lower_s:.1f}s, trace {result.compile_s:.1f}s)")
            print(f"  memory: peak {result.peak_memory_per_device:.4e} argument "
                  f"{result.argument_bytes:.4e} output {result.output_bytes:.4e} bytes")
            print(f"  cost: flops={result.flops:.3e} bytes={result.bytes_accessed:.3e}; "
                  f"kernels {lowered.kernels}")
            print(f"  collectives: n={result.n_collectives} "
                  f"wire_bytes/chip={result.collective_bytes:.3e}")
    except Exception as e:  # noqa: BLE001 — a failing cell is a recorded bug
        result.status = "failed"
        result.note = f"{type(e).__name__}: {e}"[:500]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAILED {result.note}")

    if save:
        _save(result, tag)
    return result


def _save(result: CellResult, tag: str = "") -> None:
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = ARTIFACT_DIR / f"{result.arch}_{result.shape}_{result.mesh}{suffix}.json"
    path.write_text(json.dumps(result.to_json(), indent=1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="run every cell")
    # --arch alone: every shape of that arch
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--method", default="async_sam")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device the abstract tensors lie on (the card's path either way)")
    ap.add_argument("--profile", choices=("tp", "fsdp_sp"),
                    help="trace under this sharding profile in place of the config's "
                         "(records tagged with it)")
    args = ap.parse_args()

    cells: list[tuple[str, str]] = []
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch:
        cells = [(args.arch, s) for s in ([args.shape] if args.shape else SHAPES)]
    else:
        ap.error("--arch [--shape] or --all required")

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            override = (None if args.profile is None else
                        dataclasses.replace(get_config(arch), sharding_profile=args.profile))
            r = run_cell(arch, shape, multi_pod=mp, method=args.method,
                         tag=args.tag or (args.profile or ""), device=args.device,
                         cfg_override=override)
            failures += r.status == "failed"
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
