"""Training launcher (counterpart of `repro.launch.train`).

Builds the model, the method and the optimizer as the reference does, and
runs one of three executors under `Engine.fit`:
  --executor fused   one step function per iteration (Form A)
  --executor hetero  the two-lane heterogeneous executor (Form B, paper
                     §3.3/§3.4): the ascent lane a thread, on
                     --ascent-device (e.g. cpu: the paper's CPU helper);
                     --calibrate adds the system-aware b' pre-fit probe
  --executor remote  the lanes across processes: the ascent runs in a
                     `repro_torch.service.ascent_server` (of either package);
                     --ascent-addr names a running one, --serve-ascent spawns
                     one on this machine; --job-compress int8 ships the
                     params as int8 deltas against the server's shadow
                     (the delta_amax and delta_encode_i8 kernels)
On the card by default, where the perturbation, the optimizer epilogue, the
ascent refresh, the delta encode and the sequence mixer (attention; the
rwkv6 wkv scan and its backward; zamba2's Mamba2 SSD scan and its backward
beside attention) go through the Hopper kernels; on the CPU with `--device
cpu`, through their plain versions. With `--ckpt-dir` the loop checkpoints
every `--save-every` steps and restarts from the newest checkpoint after a failed step
(`runtime.run_resilient`). Prints the reference's `step N {...}` lines, each
kernel's launch count, `done: N steps, R restarts, Xs` with `--ckpt-dir`, and
the reference's final JSON summary.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --method async_sam --steps 6 --batch 8 --seq 1024            # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --method async_sam --steps 6 --batch 8 --seq 1024            # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --method async_sam --steps 6 --batch 8 --seq 1024            # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
      --device cpu --method async_sam --steps 12 --batch 4 --seq 32 \\
      --save-every 6 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
      --device cpu --method async_sam --steps 12 --batch 4 --seq 32 \\
      --executor remote --serve-ascent --job-compress int8
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --reduced \\
      --device cpu --method looksam --steps 6 --batch 4 --seq 32

`--method` is any of the reference's eight (`core.available_methods()`):
sgd, sam, gsam, async_sam and the variants looksam, esam, aesam and mesa,
each with the `MethodConfig` defaults beyond rho, b'/b and the microbatches.
`--optimizer sgd` takes the reference launcher's sgd: momentum 0 (the
paper's momentum 0.9 is `optim.sgd(..., momentum=0.9)` through the API).

Resilience and observability, with the reference's flags, checks and exit
summaries: `--guard` (the numerics guard: the in-step skip in the epilogue
kernels, the rho de-escalation ladder, and with `--ckpt-dir` PoisonBatch
rollback; prints `guard: rung ...`), `--numchaos SPEC` (poisons float batch
leaves by the batch cursor; token batches have none, so on a language model
it is a counted no-op; prints `numchaos: fired ...`), `--lane-ladder`
(hetero/remote: remote -> thread -> ledger-only failover), `--watchdog`
(remote + --serve-ascent: restart a dead or wedged server), `--netchaos
SPEC` (remote: a frame-aware fault proxy on the wire), `--trace PATH` (a
Chrome/Perfetto trace, one track per lane) and `--telemetry-jsonl PATH`
(one record per step, the reference's bytes):

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \
      --device cpu --steps 8 --batch 4 --seq 32 --guard \
      --numchaos nan_grad:nth=5 --trace /tmp/t.json --telemetry-jsonl /tmp/t.jsonl

The reference's elastic-mesh flags (`--elastic`, `--chaos`, which needs
`--elastic`, `--model-axis`, `--resize-budget`, `--resize-window-s`) wait
for the distributed slice (ROADMAP.md queue 1, item 7) and are refused by
name.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import MethodConfig, available_methods
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import (CheckpointCallback, Engine, FusedExecutor, GuardConfig,
                                GuardedExecutor, HeteroExecutor, LoggingCallback,
                                RemoteExecutor, StalenessTelemetry, ThroughputMeter)
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import sam_perturb as sp
from repro_torch.kernels.ops import mixer_launches
from repro_torch.launch.serve import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.obs import TraceEventSink, Tracker
from repro_torch.runtime import (ExecutorConfig, NumericChaosPipeline, ResilienceConfig,
                                 parse_numchaos)

DELTA_KERNELS = ("delta_amax", "delta_encode_i8")
# the reference's elastic-mesh flags, refused by name until the distributed
# slice (ROADMAP.md queue 1, item 7): engine/elastic.py, runtime/elastic.py,
# launch/mesh.py (--chaos drives the elastic executor's mesh events)
_ITEM7 = "the distributed slice, ROADMAP.md queue 1 item 7"
NOT_PORTED_FLAGS = {flag: _ITEM7 for flag in (
    "elastic", "chaos", "model-axis", "resize-budget", "resize-window-s")}


def kernel_launches(executor: str = "fused", family: str = "dense") -> dict[str, int]:
    """Launches of every kernel of the executor's training path for a model
    family since the last reset: the family's sequence mixer (flash
    attention; the rwkv6 scan and its backward; the Mamba2 scan and its
    backward beside flash attention) and the weight-space kernels
    (the JOB-delta kernels run on the remote lane only)."""
    counts = {**mixer_launches(family, backward=True), **sp.launches, **fu.launches}
    if executor != "remote":
        counts = {k: v for k, v in counts.items() if k not in DELTA_KERNELS}
    return counts


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-trainable)")
    ap.add_argument("--method", choices=available_methods(), default="async_sam")
    ap.add_argument("--executor", choices=("fused", "hetero", "remote"), default="fused",
                    help="fused: one step function per iteration (Form A); hetero: the "
                         "two-lane async_sam; remote: the ascent lane behind "
                         "repro_torch.service")
    ap.add_argument("--calibrate", action="store_true",
                    help="hetero/remote: measure the system-aware b'/b pre-fit")
    ap.add_argument("--ascent-addr", default="",
                    help="remote only: address of a running ascent server "
                         "('host:port' or 'unix:/path')")
    ap.add_argument("--serve-ascent", action="store_true",
                    help="remote only: spawn the ascent server as a localhost subprocess "
                         "(loopback mode; --ascent-addr optional); it computes on the "
                         "descent's device")
    ap.add_argument("--job-compress", choices=("none", "int8", "topk"), default="none",
                    help="remote only: JOB-direction (params out) encoding. 'none' ships "
                         "full fp32 snapshots; int8/topk quantize the delta against the "
                         "server's shadow of the last-synced params")
    ap.add_argument("--job-delta", choices=("on", "off"), default="on",
                    help="remote only: delta-encode JOB payloads against the server's "
                         "shadow (off: every exchange ships a full snapshot)")
    ap.add_argument("--pool-workers", type=int, default=0,
                    help="remote + --serve-ascent only: ascent workers in the spawned "
                         "pool server (0 = server default)")
    ap.add_argument("--sync-group", default="",
                    help="remote only: `global` ascent-sync group name (same-group "
                         "clients get the pool's shared smoothed ascent gradient)")
    ap.add_argument("--auth-token", default="",
                    help="remote only: shared secret presented in HELLO")
    ap.add_argument("--ascent-device", default="",
                    help="hetero only: device of the slow ascent lane, e.g. 'cpu' (the "
                         "paper's CPU helper); default the descent's")
    ap.add_argument("--descent-device", default="",
                    help="hetero only: device of the fast descent lane (default --device)")
    ap.add_argument("--netchaos", default="",
                    help="remote only: interpose service.netchaos.ChaosProxy between the "
                         "client and the ascent server, driven by this fault schedule: "
                         "comma-separated 'action[:FRAME][:key=val...]', e.g. "
                         "'corrupt:GRAD:every=5,drop:JOB_DELTA:nth=7' (actions: corrupt, "
                         "truncate, drop, delay, stall, blackhole, duplicate)")
    ap.add_argument("--lane-ladder", action="store_true",
                    help="hetero/remote: health-driven degradation ladder (remote -> "
                         "in-process thread -> ledger-only), with lane_state/"
                         "lane_failovers/lane_recoveries telemetry")
    ap.add_argument("--guard", action="store_true",
                    help="numerics guard (runtime.guard): in-step skip of non-finite "
                         "updates (the epilogue kernels write nothing), loss-spike and "
                         "stale-ascent detection, the rho de-escalation ladder and, with "
                         "--ckpt-dir, PoisonBatch rollback; telemetry in guard_state/"
                         "rho_scale/steps_skipped/poison_rollbacks")
    ap.add_argument("--numchaos", default="",
                    help="deterministic numerics-chaos injector over the batch stream: "
                         "'kind[:key=val...]' rules keyed on the batch cursor, e.g. "
                         "'nan_grad:nth=40:span=8,spike:prob=0.01:scale=1e4'. Poisons "
                         "float batch leaves only: token batches pass through untouched")
    ap.add_argument("--watchdog", action="store_true",
                    help="remote + --serve-ascent only: STATS-scraping server watchdog "
                         "that restarts a dead or wedged loopback server under a budget")
    ap.add_argument("--telemetry-jsonl", default="",
                    help="write per-step tau/perturbed/step-time records here")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace-event JSON here: the descent, the "
                         "ascent lane and the pool workers as named tracks")
    for flag in NOT_PORTED_FLAGS:
        ap.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    ap.add_argument("--fused-update", choices=("auto", "on", "off"), default="auto",
                    help="flat-buffer fused perturb + optimizer epilogue (auto: on, the "
                         "kernels on the card and their plain versions on the CPU)")
    ap.add_argument("--resident", choices=("auto", "on", "off"), default="auto",
                    help="bucket-resident training state: params/opt-state persist as "
                         "dtype buckets, the step runs buffer->buffer (auto: follows the "
                         "resolved fused path; checkpoints stay per-leaf either way)")
    ap.add_argument("--restart-window-s", type=float, default=0.0,
                    help="rolling window for the checkpoint-restart budget: tolerate "
                         "--max-restarts within this many seconds instead of over the "
                         "whole run (0 = lifetime)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="checkpoint-restart budget (per --restart-window-s window when set)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--rho", type=float, default=0.05)
    ap.add_argument("--ascent-fraction", type=float, default=0.25)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    for flag, module in NOT_PORTED_FLAGS.items():
        if getattr(args, flag.replace("-", "_")) is not None:
            ap.error(f"--{flag} is not ported yet ({module})")
    lanes = args.executor in ("hetero", "remote")
    if args.calibrate and not lanes:
        ap.error("--calibrate requires --executor hetero or remote")
    if lanes and args.method != "async_sam":
        ap.error(f"--executor {args.executor} realizes async_sam only "
                 f"(got --method {args.method})")
    if (args.ascent_device or args.descent_device) and args.executor != "hetero":
        ap.error("--ascent-device/--descent-device apply to --executor hetero "
                 "only (the remote ascent device is the server's --device)")
    if (args.ascent_addr or args.serve_ascent) and args.executor != "remote":
        ap.error("--ascent-addr/--serve-ascent apply to --executor remote only")
    if ((args.job_compress != "none" or args.job_delta != "on")
            and args.executor != "remote"):
        ap.error("--job-compress/--job-delta apply to --executor remote only "
                 "(the JOB direction exists only on the wire)")
    if ((args.sync_group or args.auth_token or args.pool_workers)
            and args.executor != "remote"):
        ap.error("--pool-workers/--sync-group/--auth-token apply to "
                 "--executor remote only (they configure the ascent pool)")
    if args.pool_workers and not args.serve_ascent:
        ap.error("--pool-workers configures the spawned loopback server; "
                 "with --ascent-addr the pool size is the server's --pool-workers")
    if args.executor == "remote" and not (args.ascent_addr or args.serve_ascent):
        ap.error("--executor remote needs --ascent-addr (a running "
                 "ascent server) or --serve-ascent (loopback subprocess)")
    if args.netchaos and args.executor != "remote":
        ap.error("--netchaos applies to --executor remote only (it attacks "
                 "the ascent wire)")
    if args.lane_ladder and not lanes:
        ap.error("--lane-ladder applies to --executor hetero or remote "
                 "(the fused executor has no ascent lane to degrade)")
    if args.watchdog and not args.serve_ascent:
        ap.error("--watchdog restarts the spawned loopback server; it needs "
                 "--serve-ascent (an external server is restarted by its "
                 "own supervisor)")
    if args.watchdog and args.netchaos:
        ap.error("--watchdog and --netchaos are mutually exclusive: under "
                 "--netchaos the launcher owns the server (behind the "
                 "proxy), so the executor's watchdog could not restart it")

    device = resolve_device(args.descent_device or args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    bundle = build_model(cfg)
    mcfg = MethodConfig(name=args.method, rho=args.rho,
                        ascent_fraction=args.ascent_fraction,
                        n_microbatches=args.n_micro, guard_update=args.guard)
    optimizer = make_optimizer(args.optimizer,
                               cosine_schedule(args.lr, args.steps,
                                               warmup_steps=args.steps // 20))
    pipe = TokenPipeline(cfg, PipelineConfig(
        global_batch=args.batch, seq_len=args.seq, seed=args.seed,
        ascent_fraction=(args.ascent_fraction
                         if args.method in ("async_sam",) else 0.0)), device=device)
    numchaos = None
    if args.numchaos:
        numchaos = parse_numchaos(args.numchaos, seed=args.seed)
        pipe = NumericChaosPipeline(pipe, numchaos)
        print(f"numchaos: {len(numchaos.rules)} rules over the batch stream")
    switch = {"auto": None, "on": True, "off": False}
    fused_update, resident = switch[args.fused_update], switch[args.resident]
    netchaos_proxy = netchaos_server = None
    if args.executor == "hetero":
        exec_cfg = ExecutorConfig(
            ascent_device=resolve_device(args.ascent_device) if args.ascent_device else None,
            descent_device=device, fused_update=fused_update, resident=resident,
            lane_ladder=args.lane_ladder)
        executor = HeteroExecutor(bundle.loss_fn, mcfg, optimizer, exec_cfg=exec_cfg,
                                  calibrate=args.calibrate)
    elif args.executor == "remote":
        loss_spec = f"arch:{args.arch}" + (":reduced" if args.reduced else "")
        upstream, serve = args.ascent_addr, args.serve_ascent
        if args.netchaos:
            # the client talks to the proxy, the proxy to the real server,
            # spawned here (not by RemoteExecutor) so the proxy can
            # interpose on the loopback path too
            from repro_torch.service.ascent_server import spawn_server
            from repro_torch.service.netchaos import ChaosProxy, parse_faults
            if serve:
                netchaos_server = spawn_server(loss_spec, device=str(device),
                                               pool_workers=args.pool_workers,
                                               auth_token=args.auth_token)
                upstream, serve = netchaos_server.addr, False
            netchaos_proxy = ChaosProxy(upstream, parse_faults(args.netchaos))
            upstream = netchaos_proxy.addr
            print(f"netchaos: proxy {netchaos_proxy.addr} -> {netchaos_proxy.upstream} "
                  f"({len(netchaos_proxy.schedule.rules)} fault rules)")
        exec_cfg = ExecutorConfig(
            ascent_addr=upstream, serve_ascent=serve, loss_spec=loss_spec,
            descent_device=device, fused_update=fused_update, resident=resident,
            job_compress=args.job_compress, job_delta=(args.job_delta == "on"),
            pool_workers=args.pool_workers, sync_group=args.sync_group,
            auth_token=args.auth_token, lane_ladder=args.lane_ladder,
            watchdog=args.watchdog)
        executor = RemoteExecutor(bundle.loss_fn, mcfg, optimizer, exec_cfg=exec_cfg,
                                  calibrate=args.calibrate)
    else:
        executor = FusedExecutor(bundle.loss_fn, mcfg, optimizer,
                                 fused_update=fused_update, resident=resident)
    guard = None
    if args.guard:
        # outermost wrapper, so its verdict covers everything below;
        # PoisonBatch rollback needs the checkpoint-restart loop, so it arms
        # only with --ckpt-dir
        guard = executor = GuardedExecutor(executor, GuardConfig(rollback=bool(args.ckpt_dir)))

    model = bundle.init(args.seed, device)
    state = executor.init_state(model, args.seed + 1)

    meter = ThroughputMeter(tokens_per_batch=args.batch * args.seq)
    callbacks = [LoggingCallback(every=args.log_every, total_steps=args.steps), meter]
    if lanes or args.telemetry_jsonl:
        callbacks.append(StalenessTelemetry(jsonl_path=args.telemetry_jsonl or None))
    if args.ckpt_dir:
        callbacks.append(CheckpointCallback(
            CheckpointManager(args.ckpt_dir, keep=3),
            ResilienceConfig(save_every=args.save_every, max_restarts=args.max_restarts,
                             restart_window_s=args.restart_window_s or None,
                             require_finite_restore=args.guard)))
    tracker = Tracker([TraceEventSink(args.trace)]) if args.trace else None
    try:
        with Engine(executor, pipe, callbacks) as eng:
            report = eng.fit(state, args.steps, tracker=tracker)
    finally:
        # the launcher's netchaos plumbing (the executor tears down only what
        # it spawned itself)
        if netchaos_proxy is not None:
            netchaos_proxy.close()
        if netchaos_server is not None:
            netchaos_server.kill()
    if netchaos_proxy is not None:
        print(f"netchaos: {netchaos_proxy.connections} connections, "
              f"{netchaos_proxy.fault_count()} faults fired "
              f"{netchaos_proxy.schedule.fired_actions()}")
    if tracker is not None:
        tracker.close()
        print(f"trace written to {args.trace} (load at ui.perfetto.dev)")

    if report.pre_fit:
        pf = report.pre_fit
        print(f"calibration: configured b'/b={pf['configured_ascent_fraction']:.3f}  "
              f"system-aware b'/b={pf['calibrated_ascent_fraction']:.3f}")
    if args.ckpt_dir:
        print(f"done: {report.steps_done} steps, {report.restarts} restarts, "
              f"{report.wall_time_s:.1f}s")
    if numchaos is not None:
        print(f"numchaos: fired {dict(numchaos.fired)}"
              + (f", {numchaos.skipped_no_float} no-float-leaf skips"
                 if numchaos.skipped_no_float else ""))
    if guard is not None:
        print(f"guard: rung {guard.ladder.level} "
              f"(rho_scale {guard.cfg.rho_scales[guard.ladder.level]}), "
              f"{guard.steps_skipped} updates skipped, "
              f"{guard.poison_rollbacks} poison rollbacks")
    print(f"kernel launches: {json.dumps(kernel_launches(args.executor, cfg.family))}")
    summary = meter.summary()
    if summary:
        print(json.dumps({"arch": cfg.name, "method": args.method,
                          "executor": args.executor,
                          "steps": report.steps_done,
                          "mean_step_s": summary["mean_step_s"],
                          "tokens_per_s": summary.get("tokens_per_s")}))


if __name__ == "__main__":
    main()
