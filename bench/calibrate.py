"""Readings that set the limits of a cell's correctness check, on the card
at the cell's own size: the program's numbers over many seeds, and the
control's and the faults' over a few, in one process.

    python bench/calibrate.py --workload olmo-1b.train-asyncsam \\
        --seeds 11,12,13 --control-seeds 11,12,13 [--seconds 8]

Training cells: each seed's program readings come from the set-up path of
a run (the check steps through the engine), compared with the fp32
reference; each control seed adds the reference computed with fp8
products in the program's place (`reference.precision.fp8_mm`) and the
faults, the reference put in the program's place with them: half of each
batch's rows left out, the mean taken over the rest; the state left
unchanged; and, where the method perturbs the weights (a "rho"), the
perturbation dropped and rho doubled. Prefill cells: each seed serves a window of `--seconds` at the
cell's load and compares its sampled tokens; each control seed adds the
gap of the token that fp8 products put first on the same prompts.
One JSON line a seed on standard output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness
    from bench.kinds import prefill, train
    from bench.reference import models, precision

    if not torch.cuda.is_available():
        print("calibration runs on a CUDA card", file=sys.stderr)
        return 2
    bench = harness.benchmark(ROOT)
    _, cfg, traffic, limits = harness.cell_files(args.workload, bench, ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    port_cfg = harness.port_config(cfg)
    for seed in sorted(set(seeds) | controls):
        t0 = time.perf_counter()
        ctx = harness.Context(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                              cfg, traffic, limits, T_START)
        line = {"seed": seed}
        if traffic["kind"] == "train":
            ref = None
            if seed in seeds:
                engine, state, feed, prog = train.build(ctx, port_cfg)
                engine.close()
                del engine, state, feed
                harness.free_cuda()
                ref = train.reference(ctx)
                line["program"] = harness.train_numbers(prog, ref)
                line["losses"] = {"program": prog["loss"], "reference": ref["loss"]}
            if seed in controls:
                ref = ref or train.reference(ctx)
                low = train.reference(ctx, mm=precision.fp8_mm)
                line["control_fp8"] = harness.train_numbers(low, ref)
                half = train.reference(ctx, keep=0.5)
                line["fault_half_batch"] = harness.train_numbers(half, ref)
                still = train.reference(ctx, update=False)
                line["fault_state_unchanged"] = harness.train_numbers(still, ref)
                m = traffic["method"]
                if "rho" in m:
                    for fault, rho in (("no_perturbation", 0.0), ("rho_double", 2 * m["rho"])):
                        got = train.reference(ctx, method={**m, "rho": rho})
                        line[f"fault_{fault}"] = harness.train_numbers(got, ref)
        else:
            model = prefill.build(ctx, port_cfg)
            w = prefill.serve_window(ctx, port_cfg, model, args.seconds, False)
            picked = prefill.sample(seed, traffic, w["seq"])
            served = torch.stack([w["served"][i][r] for i, r in picked]).cpu()
            del model, w["served"]
            harness.free_cuda()
            mms = {"fp32": models.fp32_mm}
            if seed in controls:
                mms["fp8"] = precision.fp8_mm
            got = prefill.reference_logits(ctx, w["seq"], picked, mms)
            ref = got["fp32"].cpu()
            line["program"] = {"logit_gap": prefill.widest_gap(ref, served)}
            line["checked"] = len(picked)
            if "fp8" in got:
                line["control_fp8"] = {"logit_gap": prefill.widest_gap(
                    ref, got["fp8"].cpu().argmax(dim=1))}
        harness.free_cuda()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
