"""What every run of a cell shares: the cell's files found by name, the
context a kind of traffic runs in, the checks of correctness, and the
result line.

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(its `file`, a JSON object of the model's sizes and its `arch`) and a
traffic mix (`bench/traffic/<traffic>.json`, whose "kind" names the module
of `bench/kinds/` that drives the window). Its limits of correctness are
`bench/limits/<cell>.json`. A per-layer metric is read by
`bench/metrics/<metric>.py`.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import statistics
import sys
from typing import Optional

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Check:
    """A number compared with its limit: correct while value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Context:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: object                     # torch.device
    cfg: dict                          # the configuration file
    traffic: dict
    limits: dict
    t_start: float                     # perf_counter at process start


@dataclasses.dataclass
class Outcome:
    """What a kind of traffic hands back from one run."""
    metrics: dict[str, float]          # end-to-end values by name, setup_s included
    attempted: int
    failed: int
    checks: list[Check]
    memory_peak_bytes: int
    trace: object = None               # trace.Trace of the traced stretch
    traced_flops: float = 0.0          # model FLOPs of the work in the traced stretch
    notes: list[str] = dataclasses.field(default_factory=list)


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, bench: dict, root: pathlib.Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(the workload entry, the configuration file, the traffic, the limits)
    of cell `name`."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (cell, load_json(root / conf["file"]),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            load_json(BENCH / "limits" / f"{name}.json"))


def kind_module(traffic: dict):
    return importlib.import_module(f"bench.kinds.{traffic['kind']}")


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, name: str, traced: bool) -> list[dict]:
    """The metrics a run of cell `name` reports: its end-to-end ones
    (`traced` False) or its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def port_config(cfg: dict):
    """The program's ModelConfig of the configuration file's `arch` (its
    small preset where "preset" is "reduced": the CPU tests'), checked
    against every size the file states."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    port = get_config(cfg["arch"], reduced=cfg.get("preset") == "reduced")
    have = dc.asdict(port)
    for key, want in cfg.items():
        if key in have and key != "name" and have[key] != want:
            raise ValueError(f"{cfg['arch']}: the program's {key} is {have[key]!r}, "
                             f"the configuration file's {want!r}")
    return port


def quantile(values: list[float], q: float) -> float:
    """The q-quantile by the nearest rank of the sorted values."""
    v = sorted(values)
    return v[min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))]


def rel_gap(got: float, want: float, scale: float) -> float:
    return abs(got - want) / scale if scale > 0 else (0.0 if got == want else math.inf)


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap between the program's and the reference's norm
    of that leaf, over the larger of its and the median leaf's reference
    norm."""
    med = statistics.median(ref.values())
    return max(rel_gap(prog[n], r, max(r, med)) for n, r in ref.items())


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """The training cells' numbers: each step's loss against the
    reference's (relative, "loss_gap"); by `leaf_gap`, the leaf norms of
    the first step's gradient ("grad_norm_gap") and of the change of the
    weights over the checked steps ("change_norm_gap"); where the method
    holds an ascent gradient, that of the first step by `leaf_gap` and its
    global norm, relative ("ascent_norm_gap", the larger); where it
    perturbs the weights, the second step's perturbation by `leaf_gap`
    ("perturbation_norm_gap"). The change leaves out the leaves whose first
    reference gradient is under a thousandth of the median leaf's:
    round-off alone moves them under Adam."""
    loss = max(rel_gap(p, r, abs(r)) for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = math.inf
    g_med = statistics.median(ref["grad"].values())
    kept = {n for n, r in ref["grad"].items() if r >= 1e-3 * g_med}
    out = {"loss_gap": loss, "grad_norm_gap": leaf_gap(prog["grad"], ref["grad"]),
           "change_norm_gap": leaf_gap(prog["change"],
                                       {n: r for n, r in ref["change"].items() if n in kept})}
    if "ascent" in ref:
        out["ascent_norm_gap"] = (max(leaf_gap(prog["ascent"], ref["ascent"]),
                                      rel_gap(prog["ascent_norm"], ref["ascent_norm"],
                                              ref["ascent_norm"]))
                                  if "ascent" in prog else math.inf)
    if "perturbation" in ref:
        out["perturbation_norm_gap"] = (leaf_gap(prog["perturbation"], ref["perturbation"])
                                        if "perturbation" in prog else math.inf)
    return out


def train_checks(prog: dict, ref: dict, limits: dict) -> list[Check]:
    """`train_numbers` compared with the cell's limits, those it names."""
    return [Check(name, v, limits[name]) for name, v in train_numbers(prog, ref).items()
            if name in limits]


def free_cuda() -> None:
    """Give the card's memory back once the program is done with it."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def jax_loaded() -> list[str]:
    """Top-level names in sys.modules that the benchmark's process must not
    hold: JAX and the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, count: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak), "power_limit": power_limit()}


def result(bench: dict, name: str, out: Outcome, device: dict, traced: bool) -> dict:
    """The result line of a run of cell `name`: its end-to-end metrics, or
    with `traced` its per-layer ones (those a reader finds), the device
    (with the traced run's busy and window seconds), a breakdown of the
    traced stretch, and the checks, last."""
    metrics = {}
    for m in cell_metrics(bench, name, traced):
        value = metric_reader(m["name"])(out) if traced else out.metrics[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": all(c.ok for c in out.checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.top_device_ops(),
                             "idle_gaps": out.trace.idle_gaps()}
        out.notes.append(f"device operations charged by {out.trace.attribution}")
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it, or None."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None
