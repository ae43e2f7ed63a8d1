"""RemoteExecutor — the hetero schedule with the ascent lane in another
process or on another host (counterpart of `repro.engine.remote`).

Descent runs here; the ascent gradient arrives over the wire from a
`service.ascent_server` (of this package or the reference's; another host,
or in loopback mode a subprocess on this machine). Everything above the lane
is shared with `HeteroExecutor`: the same `AsyncSamExecutor` step, staleness
ledger, calibration pre-fit hook and executor surface, so `Engine.fit`
drives it unchanged and a loopback run matches `HeteroExecutor` step for step
under `ExecutorConfig(lockstep=True)` with full snapshots.

Wiring (ExecutorConfig fields):

    ascent_addr    "host:port" / "unix:/path" of a running server
    serve_ascent   loopback: spawn the server subprocess here; `loss_spec`
                   ("module:attr" | "arch:NAME[:reduced]") tells it what loss
                   to hold; it computes on `descent_device` (the card unless
                   told otherwise), the counterpart of the reference server
                   landing on JAX's default device
    max_server_respawns  loopback: a server that dies mid-fit is respawned
                   (in-flight gradients are lost, tau records the gap)
    job_compress   "none": full fp32 snapshots; "int8" / "topk": deltas
                   against the server's shadow (`service.delta`), int8
                   through the `delta_amax` and `delta_encode_i8` kernels

Step metrics additionally carry `wire_bytes` (the last JOB + GRAD exchange),
its split `job_bytes` / `grad_bytes`, and `rtt_s`. The reference's server
watchdog (`runtime/health.py`) is a later slice: `ExecutorConfig(watchdog=
True)` raises.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.core import MethodConfig, TrainState
from repro_torch.core.api import LossFn
from repro_torch.core.ascent import Compressor
from repro_torch.engine.hetero import HeteroExecutor
from repro_torch.optim import GradientTransform
from repro_torch.runtime.async_executor import ExecutorConfig
from repro_torch.service.ascent_server import ServerHandle, spawn_server
from repro_torch.service.client import RemoteAscentClient


class RemoteExecutor(HeteroExecutor):
    """Two-host executor: descent here, ascent behind `service.protocol`."""

    name = "remote"

    def __init__(self, loss_fn: LossFn, method_cfg: Optional[MethodConfig] = None,
                 optimizer: Optional[GradientTransform] = None, *,
                 exec_cfg: Optional[ExecutorConfig] = None,
                 calibrate: bool = False, calibration_probes: int = 3,
                 loss_spec: str = ""):
        xcfg = exec_cfg or ExecutorConfig()
        method_cfg = method_cfg or MethodConfig()
        self._loss_spec = loss_spec or xcfg.loss_spec
        self._server_device = str(xcfg.descent_device) if xcfg.descent_device else ""
        self.server: Optional[ServerHandle] = None
        self.server_respawns = 0
        addr = xcfg.ascent_addr
        if xcfg.serve_ascent:
            if not self._loss_spec:
                raise ValueError(
                    "serve_ascent=True needs a loss_spec ('module:attr' or "
                    "'arch:NAME[:reduced]') so the spawned server knows which loss "
                    "function to hold")
            self.server = self._spawn(addr or "127.0.0.1:0", xcfg)
            addr = self.server.addr
        if not addr:
            raise ValueError("RemoteExecutor needs ExecutorConfig.ascent_addr "
                             "(a running ascent server) or serve_ascent=True")
        self.client = RemoteAscentClient(
            addr,
            Compressor(kind=method_cfg.compressor, topk_fraction=method_cfg.topk_fraction),
            connect_timeout_s=xcfg.connect_timeout_s,
            reconnect_backoff_s=xcfg.reconnect_backoff_s,
            job_encoding=xcfg.job_compress,
            job_delta=xcfg.job_delta,
            # lockstep runs retry an interrupted exchange as a snapshot of
            # the encoder's shadow, so a server kill stays transparent
            retry_inflight=xcfg.lockstep,
            client_id=xcfg.client_id,
            sync_group=xcfg.sync_group,
            auth_token=xcfg.auth_token)
        try:
            super().__init__(loss_fn, method_cfg, optimizer, exec_cfg=xcfg,
                             calibrate=calibrate, calibration_probes=calibration_probes,
                             ascent_lane=self.client)
        except BaseException:
            self.client.close()
            if self.server is not None:
                self.server.kill()
            raise
        self.xcfg = xcfg
        self._server_lock = threading.Lock()

    def _spawn(self, bind: str, xcfg: ExecutorConfig) -> ServerHandle:
        return spawn_server(self._loss_spec, bind=bind, device=self._server_device,
                            delay_s=xcfg.ascent_delay_s, pool_workers=xcfg.pool_workers,
                            auth_token=xcfg.auth_token)

    def _maybe_respawn_server(self) -> None:
        """A died loopback server is replaced (within budget) and the client
        pointed at the new address. The exchange in flight is lost (tau
        records the gap); a respawn that itself fails burns one attempt and
        the run continues on the ledger."""
        with self._server_lock:
            if self.server is None or self.server.alive():
                return
            if self.server_respawns >= self.xcfg.max_server_respawns:
                return
            self.server_respawns += 1
            try:
                self.server = self._spawn("127.0.0.1:0", self.xcfg)
            except RuntimeError as e:
                self.client._note_error(f"server respawn failed: {e}")
                return
            self.client.set_address(self.server.addr)

    def step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        self._maybe_respawn_server()
        return super().step(state, batch)

    def close(self) -> None:
        super().close()              # inner executor -> client (lane) close
        if self.server is not None:
            self.server.kill()
