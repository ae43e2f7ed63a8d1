"""Run one cell of the benchmark of the PyTorch and CUDA port (`repro_torch`)
on the machine's card, and print its result as the last line of standard
output (one JSON object).

    python bench/run.py --workload olmo-1b.train-asyncsam --seed 7 --seconds 30 --trace 0

From the root of a checkout. `--trace 0` reports the cell's end-to-end
metrics; `--trace 1` runs the same window with the profiler over a short
stretch of it and reports the cell's per-layer metrics, the device's busy
and traced seconds, and a breakdown. Every run checks what its timed path
produced against the plain reference (`bench/reference`) and prints each
number compared beside its limit, last on standard error and under
"checks" in the result. It exits with another code than 0, and prints no
result, without a CUDA card (or with fewer than the cell asks for), or if
JAX or the JAX package (`repro`) is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed place inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness

    bench = harness.benchmark(ROOT)
    cell, cfg, traffic, limits = harness.cell_files(args.workload, bench, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = harness.Context(workload=args.workload, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device("cuda", 0), cfg=cfg,
                          traffic=traffic, limits=limits, t_start=T_START)
    out = harness.kind_module(traffic).run(ctx)

    if args.trace and out.trace is None:
        print("the window ended before its traced stretch", file=sys.stderr)
        return 4
    device = harness.device_info(torch, cell["chips"], out.memory_peak_bytes)
    result = harness.result(bench, args.workload, out, device, traced=bool(args.trace))

    loaded = harness.jax_loaded()
    if loaded:
        print(f"the benchmark's process holds {loaded} after the window", file=sys.stderr)
        return 3
    for note in out.notes:
        print(note, file=sys.stderr)
    print(f"card {device['kind']}, power limit {device['power_limit']}", file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
