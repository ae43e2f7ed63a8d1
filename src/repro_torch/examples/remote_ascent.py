"""Multi-host AsyncSAM on one machine: the loopback ascent service.

Spawns a real `repro_torch.service.ascent_server` subprocess, then trains
with `--executor remote` semantics: the descent lane runs here, and every
ascent gradient crosses a TCP socket as a GRAD frame. Two demonstrations:

1. parity: under `ExecutorConfig(lockstep=True)` the remote run reproduces
   the in-process hetero run step for step (same tau schedule, same losses):
   moving the lane across the process boundary changes nothing about the
   math, only where it executes;
2. free-running: the async schedule with int8-compressed exchanges,
   reporting the tau histogram, the measured wire bytes and round-trip time.

The server computes on the descent's device (`--device`). A JOB frame that
carries a full snapshot of the parameters must stay under the wire's 2 GiB
frame bound (`service.protocol`); the model here is checked against it
before anything is spawned. The same two commands split across two hosts
give the paper's CPU-helper + accelerator deployment (README, "Multi-host
ascent service").

    PYTHONPATH=src python -m repro_torch.examples.remote_ascent [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import optim
from repro_torch.core import MethodConfig, slice_ascent_batch
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.engine import Engine, HeteroExecutor, RemoteExecutor, StalenessTelemetry
from repro_torch.launch.serve import resolve_device
from repro_torch.runtime import ExecutorConfig
from repro_torch.service import protocol
from repro_torch.service.testing import MLP_LOSS_SPEC, mlp_init, mlp_loss
from repro_torch.utils.buckets import tree_view

TASK = ClassificationTask(seed=7, margin=1.05, dim=64)
STEPS, BATCH, FRAC = 40, 512, 0.5
ASYNC_STEPS = 120
WIDTHS = (64, 256, 256, 10)


def accuracy(params, batch) -> float:
    with torch.no_grad():
        logits = mlp_loss(tree_view(params), batch)[1]["logits"]
    return float(torch.mean((torch.argmax(logits, -1) == batch["y"]).float()))


def snapshot_frame_bytes(widths, batch: int) -> int:
    """The bytes of a full-snapshot JOB frame of the MLP of `widths` with
    its ascent rows, counted from shapes (zero-stride stand-ins: nothing of
    the model's size is allocated); raises if it passes the wire's 2 GiB
    frame bound."""
    host = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        host[f"w{i}"] = np.broadcast_to(np.float32(0), (a, b))
        host[f"b{i}"] = np.broadcast_to(np.float32(0), (b,))
    rows = next(TASK.train_batches(batch, 1, device="cpu"))
    sliced = {k: v.numpy() for k, v in slice_ascent_batch(rows, FRAC).items()}
    n = protocol.job_frame_bytes("none", host, sliced, np.zeros(2, np.uint32), delta=False)
    if n - protocol.FRAME_HEADER_BYTES >= protocol._MAX_PAYLOAD:
        raise ValueError(f"a snapshot JOB of widths {widths} is {n} bytes, past the wire's "
                         f"{protocol._MAX_PAYLOAD}-byte frame bound: use fewer or narrower "
                         f"layers, or job_compress='int8'")
    return n


def fit(executor, device, steps, batch, widths):
    telemetry = StalenessTelemetry(print_summary=False)
    with executor as ex:
        state = ex.init_state(mlp_init(0, widths, device=device), 1)
        batches = [{**b, "ascent": slice_ascent_batch(b, FRAC)}
                   for b in TASK.train_batches(batch, steps, device=device)]
        report = Engine(ex, batches, [telemetry]).fit(state, steps)
    return report, telemetry.summary()


def main(argv=None, *, steps: int = STEPS, async_steps: int = ASYNC_STEPS,
         batch: int = BATCH, widths=WIDTHS) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the descent's and the server's device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    opt = lambda: optim.sgd(0.05, momentum=0.9)  # noqa: E731
    frame = snapshot_frame_bytes(widths, batch)
    print(f"snapshot JOB frame: {frame} bytes (bound {protocol._MAX_PAYLOAD})")
    valid = TASK.valid_set(device=device)

    # --- 1. parity: lockstep hetero vs lockstep remote --------------------------
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=FRAC)
    rep_h, _ = fit(HeteroExecutor(
        mlp_loss, mcfg, opt(), exec_cfg=ExecutorConfig(lockstep=True)),
        device, steps, batch, widths)
    rep_r, _ = fit(RemoteExecutor(
        mlp_loss, mcfg, opt(),
        exec_cfg=ExecutorConfig(lockstep=True, serve_ascent=True, descent_device=device,
                                loss_spec=MLP_LOSS_SPEC)),
        device, steps, batch, widths)
    lh = np.array([h["loss"] for h in rep_h.metrics_history])
    lr = np.array([h["loss"] for h in rep_r.metrics_history])
    parity = float(np.max(np.abs(lh - lr)))
    print(f"parity : hetero acc={accuracy(rep_h.final_state.params, valid):.4f}  "
          f"remote acc={accuracy(rep_r.final_state.params, valid):.4f}  "
          f"max|loss diff|={parity:.2e}")

    # --- 2. free-running async schedule with a compressed wire ------------------
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=FRAC, compressor="int8")
    ex = RemoteExecutor(mlp_loss, mcfg, opt(), calibrate=True,
                        calibration_probes=1,   # warms spawn, connect and the first calls
                        exec_cfg=ExecutorConfig(serve_ascent=True, descent_device=device,
                                                loss_spec=MLP_LOSS_SPEC))
    rep, tel = fit(ex, device, async_steps, batch, widths)
    wire = [h["wire_bytes"] for h in rep.metrics_history if h.get("wire_bytes")]
    rtt = [h["rtt_s"] for h in rep.metrics_history if h.get("rtt_s")]
    acc = accuracy(rep.final_state.params, valid)
    print(f"async  : acc={acc:.4f}  tau_hist={tel['tau_hist']}  "
          f"exchanges={ex.client.exchanges}")
    print(f"         wire/exchange={int(np.mean(wire)) if wire else 0}B (int8)"
          f"  rtt={np.mean(rtt) * 1e3 if rtt else 0:.1f}ms"
          f"  calibrated b'/b={rep.pre_fit['calibrated_ascent_fraction']:.2f}")
    print("-> same Engine.fit, same step math; only the lane moved across")
    print("   the process boundary. Point --ascent-addr at another host to")
    print("   split it across machines.")
    return {"snapshot_frame_bytes": frame, "parity_max_loss_diff": parity,
            "hetero_losses": lh.tolist(), "remote_losses": lr.tolist(),
            "async_acc": acc, "tau_hist": tel["tau_hist"], "exchanges": ex.client.exchanges,
            "wire_bytes": wire, "final_loss": float(rep.metrics_history[-1]["loss"])}


if __name__ == "__main__":
    main()
