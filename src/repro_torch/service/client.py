"""RemoteAscentClient — the descent host's end of the multi-host ascent lane
(counterpart of `repro.service.client`).

Satisfies the same `AscentLane` protocol as the in-process thread lane
(`runtime.async_executor.ThreadAscentLane`): `submit` is non-blocking with a
depth-1 job queue (the paper's depth-1 exchange — backpressure, not
buffering), `poll` harvests finished gradients, and a single worker thread
owns the socket: connect + HELLO handshake, send JOB, await GRAD, reconnect
with backoff on any drop.

Reconnect-and-reset semantics mirror the generation-fenced `reset()` of the
executor: a connection drop loses exactly the in-flight exchange (the job
that was on the wire and whatever the server was computing), the held-
gradient staleness ledger on the executor side keeps aging (tau grows, then
SGD fallback), and training never stalls on a dead helper. `close()` is
shutdown-safe for a client that never managed to connect: the connect loop
polls the stop event between bounded attempts, so the join cannot hang.

The JOB direction is encoded by `service.delta.JobEncoder` at submit time
(on the executor thread, before the next descent writes the params in
place):
full snapshots by default, delta+quantized bucket sections against a shared
shadow when `job_encoding`/`job_delta` ask for it and the HELLO handshake
negotiated a server that understands them. Any event that could skew the
server's shadow — connection drop, RESYNC frame, executor reset — falls
back to a full-snapshot JOB. With `retry_inflight` (the lockstep test
mode), a dropped exchange is resent as a snapshot of the encoder's shadow
instead of being reported lost, so a mid-fit server kill stays bitwise
transparent to the training schedule.

Against a multi-client pool server (protocol revision 3) the client also
declares its identity in HELLO — `client_id` (stable across reconnects),
`sync_group` (same-group clients receive the pool's shared smoothed ascent
gradient per generation/step), `auth_token` (non-loopback listeners) — and
handles the pool's two new frames: BUSY (queue saturated; the exchange is
reported lost and the executor's staleness ledger absorbs it) and DETACH
(the canonical shadow's epoch moved past this stream; the encoder
fast-forwards and re-installs with a snapshot). Reconnects use jittered
exponential backoff so a restarted pool is not thundering-herded by its
whole fleet.

The batch and the rng cross to the host at submit (`host_tree`: numpy, dict
keys sorted, as the reference's `jax.device_get` gives them); the rng is the
uint32[2] key the executor derives (`core.api.lane_key`). The reference's
tracker span per exchange comes with the tracker slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

import os
import queue
import random
import sys
import threading
import time
from typing import Any, Optional

import numpy as np

from repro_torch.core.ascent import Compressor
from repro_torch.runtime.async_executor import drain_queue, host_tree, poll_queue
from repro_torch.service import protocol
from repro_torch.service.delta import EncodedJob, JobEncoder
from repro_torch.service.pool import client_uid
from repro_torch.service.protocol import FrameType, ProtocolError
from repro_torch.utils import buckets

Pytree = Any

_client_seq = [0]
_client_seq_lock = threading.Lock()


def _default_client_id() -> str:
    """Process-unique default identity (the pool keys private canonical
    shadows and error-feedback streams by it, so same-client reconnects must
    present the same id while two clients in one process must not)."""
    with _client_seq_lock:
        _client_seq[0] += 1
        return f"client-{os.getpid()}-{_client_seq[0]}"


def reconnect_delay(attempt: int, base_s: float, cap_s: float,
                    rand=random.random) -> float:
    """Jittered exponential reconnect backoff (attempt counts from 1).

    The exponential span doubles per failed attempt up to `cap_s`; the delay
    is drawn uniformly from [span/2, span] so N clients that lost the same
    pool at the same instant spread their retries instead of thundering-herd
    reconnecting in lockstep (the pre-pool client slept a FIXED
    `reconnect_backoff_s`, synchronizing the whole fleet). `rand` is
    injectable for deterministic tests.
    """
    span = min(float(cap_s), float(base_s) * (2.0 ** (max(1, attempt) - 1)))
    return span * (0.5 + 0.5 * rand())


class RemoteAscentClient:
    """Non-blocking client for `repro_torch.service.ascent_server` (or the
    reference's server)."""

    #: the executor hands this lane the live (device) params; the encoder
    #: owns the host hop (and shrinks it to the quantized delta when enabled)
    encodes_jobs = True
    #: trace track this lane's rpc spans render on
    lane_name = "ascent-remote"

    def __init__(self, addr: str, compressor: Optional[Compressor] = None, *,
                 connect_timeout_s: float = 60.0,
                 reconnect_backoff_s: float = 0.25,
                 reconnect_backoff_max_s: float = 8.0,
                 job_encoding: str = "none", job_delta: bool = True,
                 job_topk_fraction: Optional[float] = None,
                 retry_inflight: bool = False,
                 client_id: str = "", sync_group: str = "",
                 auth_token: str = ""):
        self._addr = addr
        self._addr_lock = threading.Lock()
        self._compressor = compressor or Compressor(kind="none")
        self.connect_timeout_s = connect_timeout_s
        self.reconnect_backoff_s = reconnect_backoff_s
        self.reconnect_backoff_max_s = reconnect_backoff_max_s
        self.retry_inflight = retry_inflight
        self.client_id = client_id or _default_client_id()
        self.client_uid = client_uid(self.client_id)
        self.sync_group = sync_group
        self.auth_token = auth_token
        # negotiated server capabilities (set by the worker at HELLO time):
        # None = never connected, False = revision-1 server (legacy JOB
        # frames only), True = v2 jobs accepted
        self._v2_ok: Optional[bool] = None
        self._srv_encodings: set = set()
        self._srv_pool = False   # proto>=3 ACK: GRADs carry the pool prelude
        self._encoder = JobEncoder(
            job_encoding,
            topk_fraction=(job_topk_fraction
                           if job_topk_fraction is not None
                           else self._compressor.topk_fraction),
            delta=job_delta,
            caps_fn=lambda: (self._v2_ok, self._srv_encodings))
        self._jobs: queue.Queue = queue.Queue(maxsize=1)
        self._results: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._closed = False
        self._sock = None
        self.connected = threading.Event()
        # telemetry
        self.reconnects = 0          # successful (re)connections after the first
        self.drops = 0               # exchanges lost to a dead connection
        self.retried_exchanges = 0   # exchanges resent after a drop (lockstep)
        self.server_errors = 0       # ERROR frames (connection stayed up)
        self.busy_rejections = 0     # BUSY frames (pool queue saturated)
        self.detaches = 0            # DETACH frames (shadow epoch moved on)
        self.last_error = ""         # last server/exchange failure, for ops
        self.fatal_error = ""        # auth rejection: the worker gave up
        self.last_pool_depth = 0
        self.last_pool_wait_s = 0.0
        self._connect_failures = 0   # consecutive, drives the backoff
        self.exchanges = 0
        self.wire_in_bytes = 0       # totals over the client's life
        self.wire_out_bytes = 0
        self.last_rtt_s = 0.0
        self.last_wire_in_bytes = 0  # GRAD frame length of the last exchange
        self.last_wire_out_bytes = 0
        self.wire_bytes_per_exchange = 0   # measured GRAD frame bytes
        self.last_job_kind = ""            # "snapshot" | "int8" | "topk"
        #: measured JOB frame bytes of the last exchange, per job kind —
        #: what run_remote asserts against `protocol.job_frame_bytes`
        self.job_frame_measured: dict = {}
        self.timings: list[float] = []     # per-exchange round-trip seconds
        self._ever_connected = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # --- AscentLane surface ----------------------------------------------------
    def full(self) -> bool:
        return self._jobs.full()

    @property
    def job_encoder(self) -> JobEncoder:
        return self._encoder

    def submit(self, gen: int, params: Pytree, batch: Pytree, rng,
               step: int) -> bool:
        if self.fatal_error:
            raise RuntimeError(f"ascent service at {self.address} rejected "
                               f"this client: {self.fatal_error}")
        if self._jobs.full():
            return False
        # encode advances the shadow, so it must not run for a job that
        # cannot be queued — with the executor as the only submitter the
        # full() check above guarantees the put below succeeds
        job = self._encoder.encode(gen, params, host_tree(batch), np.asarray(rng), step)
        try:
            self._jobs.put_nowait(job)
        except queue.Full:
            return False
        return True

    def poll(self, block: bool = False, timeout: Optional[float] = None):
        if self.fatal_error:
            # fail fast instead of letting a blocking waiter sit out its
            # whole timeout against a server that will never answer us
            raise RuntimeError(f"ascent service at {self.address} rejected "
                               f"this client: {self.fatal_error}")
        return poll_queue(self._results, block, timeout)

    def probe(self, params: Pytree, batch: Pytree, rng, probes: int) -> float:
        """Timed blocking round trips for calibrate(): measures the real slow
        lane — server compute plus the wire. The first exchange (connect +
        server's first-call set-up) is the excluded warmup."""
        def once(timeout):
            if not self.submit(0, params, batch, rng, 0):
                raise RuntimeError("probe: remote lane busy")
            got = self.poll(block=True, timeout=timeout)
            if got is None:
                raise RuntimeError(
                    f"ascent service at {self.address} did not answer the "
                    f"calibration probe within {timeout:.0f}s")
            return got

        once(self.connect_timeout_s + 600.0)   # warmup: connect + compile
        t0 = time.perf_counter()
        for _ in range(probes):
            once(600.0)
        return time.perf_counter() - t0

    def reset(self) -> None:
        drain_queue(self._jobs)
        drain_queue(self._results)
        # a reset means the params timeline moved under us (checkpoint
        # restore / generation fence) — resync the delta stream
        self._encoder.invalidate()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._drop_socket()          # unblocks a worker inside recv/sendall
        self.reset()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- address / connection --------------------------------------------------
    @property
    def address(self) -> str:
        with self._addr_lock:
            return self._addr

    def set_address(self, addr: str) -> None:
        """Point at a replacement server (loopback respawn); forces reconnect."""
        with self._addr_lock:
            self._addr = addr
        self._drop_socket()

    def wait_connected(self, timeout: float) -> bool:
        return self.connected.wait(timeout)

    def _note_error(self, msg: str) -> None:
        """Record the failure and print it once per distinct message (a
        persistent server-side fault would otherwise be invisible: the run
        keeps completing steps in SGD fallback)."""
        if msg != self.last_error:
            print(f"[remote-ascent] {msg}", file=sys.stderr, flush=True)
        self.last_error = msg

    def _drop_socket(self) -> None:
        sock, self._sock = self._sock, None
        self.connected.clear()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _connect_once(self):
        """Attempt one connect + HELLO handshake; returns the socket or None."""
        try:
            sock = protocol.connect(self.address, timeout=2.0)
        except OSError:
            return None
        try:
            protocol.send_frame(sock, FrameType.HELLO,
                                protocol.encode_hello(
                                    self._compressor,
                                    client_id=self.client_id,
                                    group=self.sync_group,
                                    token=self.auth_token))
            ftype, payload, _ = protocol.recv_frame(sock, stop=self._stop,
                                                    timeout=30.0)
            if ftype == FrameType.ERROR:
                msg = payload.decode(errors="replace")
                if msg.startswith("auth-rejected"):
                    # a retry loop cannot fix a bad shared token: surface a
                    # fatal error (submit/poll raise) instead of silently
                    # reconnect-spamming a server that will keep refusing
                    self.fatal_error = msg
                    self._note_error(msg)
                raise ProtocolError(f"HELLO refused: {msg}")
            if ftype != FrameType.HELLO_ACK:
                raise ProtocolError(f"expected HELLO_ACK, got {ftype.name}")
            _, ack = protocol.decode_hello(payload)
        except (OSError, ProtocolError, TimeoutError, ConnectionError):
            try:
                sock.close()
            except OSError:
                pass
            return None
        # capability negotiation: a revision-1 server's ACK has no "proto"
        # key — degrade to full-snapshot legacy JOB frames instead of
        # failing mid-fit with an unknown-frame error
        proto = int(ack.get("proto") or 0)
        v2 = proto >= 2
        self._srv_encodings = set(ack.get("job_encodings") or []) if v2 else set()
        self._v2_ok = v2
        # gate on the revision that INTRODUCED the pool GRAD prelude, not
        # the moving PROTO_REVISION: a rev-3 server emits the prelude for
        # any client declaring proto>=3, and this client must decode it
        self._srv_pool = proto >= protocol.POOL_REVISION
        if not v2:
            self._encoder.invalidate()
        self._sock = sock
        self._connect_failures = 0
        if self._ever_connected:
            self.reconnects += 1
        self._ever_connected = True
        self.connected.set()
        return sock

    # --- worker ----------------------------------------------------------------
    def _frame_for(self, job: EncodedJob) -> tuple[FrameType, bytes]:
        """Frame a queued job for the negotiated protocol revision."""
        if self._v2_ok:
            return FrameType.JOB_DELTA, protocol.encode_job_v2(
                job.sync, job.seq, job.gen, job.step, job.batch, job.rng,
                params=job.params, kind=job.kind, deltas=job.deltas)
        if job.kind != "snapshot":
            # a delta job raced a reconnect onto a revision-1 server; it
            # cannot be expressed there — the caller drops the exchange
            raise ProtocolError(
                "delta-encoded job against a revision-1 server")
        return FrameType.JOB, protocol.encode_job(
            job.gen, job.step, job.params, job.batch, job.rng)

    def _worker(self) -> None:
        pending: Optional[EncodedJob] = None   # carried across retries
        while not self._stop.is_set():
            # local reference: set_address()/close() may null self._sock from
            # another thread at any point (the closed socket then raises
            # OSError here, which is the reconnect path, not a crash)
            sock = self._sock
            if sock is None:
                sock = self._connect_once()
                if sock is None:
                    if self.fatal_error:
                        # auth rejection: the server will keep refusing this
                        # token — stop retrying, surface via submit()/poll()
                        self._post_failure(0)
                        return
                    # bounded attempts + stop polling: a client that never
                    # connects still closes promptly (no hanging join);
                    # jittered exponential backoff so a restarted pool is
                    # not thundering-herded by its whole fleet at once
                    self._connect_failures += 1
                    self._stop.wait(reconnect_delay(
                        self._connect_failures, self.reconnect_backoff_s,
                        self.reconnect_backoff_max_s))
                    continue
            if pending is None:
                try:
                    pending = self._jobs.get(timeout=0.1)
                except queue.Empty:
                    continue
            if self._stop.is_set():
                break
            job = pending
            t0 = time.perf_counter()
            try:
                ftype_out, out_payload = self._frame_for(job)
                out_bytes = protocol.send_frame(sock, ftype_out, out_payload)
                # no deadline: a slow helper is staleness, not an error —
                # a dead one surfaces as a socket error / EOF
                ftype, payload, in_bytes = protocol.recv_frame(
                    sock, stop=self._stop)
                if ftype == FrameType.ERROR:
                    # server-side compute failure: the connection is still
                    # good (the server kept its loop and its shadow — a
                    # delta job was applied before the ascent ran), only
                    # this exchange is lost — surface the diagnostic
                    pending = None
                    self.server_errors += 1
                    self._note_error("ascent server error: "
                                     + payload.decode(errors="replace"))
                    self._post_failure(job.gen)
                    continue
                if ftype == FrameType.BUSY:
                    # pool queue saturated: the job was applied to the
                    # shadow but NOT computed — the delta stream is intact,
                    # only this exchange is lost (the executor's staleness
                    # ledger absorbs it, eventually SGD fallback)
                    pending = None
                    self.busy_rejections += 1
                    info = protocol.decode_busy(payload)
                    self.last_pool_depth = int(info.get("depth") or 0)
                    self._note_error(
                        f"pool busy (queue depth {info.get('depth')}); "
                        "exchange deferred to the staleness ledger")
                    self._post_failure(job.gen)
                    continue
                if ftype == FrameType.DETACH:
                    # the canonical shadow's epoch moved past our stream
                    # (another client or a reconnect advanced it): fast-
                    # forward the encoder's sync floor and re-install with a
                    # snapshot of the shadow — bitwise the same params
                    info = protocol.decode_resync(payload)
                    self.detaches += 1
                    self._encoder.fast_forward(int(info.get("sync") or 0))
                    retry = self._encoder.resync_job(job)
                    if retry is None:
                        pending = None
                        self._encoder.invalidate()
                        self.drops += 1
                        self._note_error("detached from canonical shadow "
                                         f"({info.get('reason')}); "
                                         "exchange dropped")
                        self._post_failure(job.gen)
                    else:
                        pending = retry
                        self.retried_exchanges += 1
                    continue
                if ftype == FrameType.RESYNC:
                    # the server's shadow cannot take this delta (fresh
                    # process, skewed sync/seq): resend as a full snapshot
                    # of the encoder's shadow — bitwise the same params
                    info = protocol.decode_resync(payload)
                    retry = self._encoder.resync_job(job)
                    if retry is None:
                        pending = None
                        self._encoder.invalidate()
                        self.drops += 1
                        self._note_error("resync requested "
                                         f"({info.get('reason')}); "
                                         "exchange dropped")
                        self._post_failure(job.gen)
                    else:
                        pending = retry
                        self.retried_exchanges += 1
                    continue
                if ftype != FrameType.GRAD:
                    raise ProtocolError(f"expected GRAD, got {ftype.name}")
                rtt = time.perf_counter() - t0
                rgen, _job_step, norm, compute_s, leaves, pool_meta = \
                    protocol.decode_grad(payload, pool=self._srv_pool)
                g = buckets.host_unflatten(job.treedef, leaves)
            except ConnectionAbortedError:
                break        # close() interrupted the wait
            except (OSError, ConnectionError, ProtocolError, TimeoutError) as e:
                if self._stop.is_set():
                    break    # close() tore the socket down, not a real drop
                self._drop_socket()   # in-flight exchange is interrupted
                if self.retry_inflight:
                    # lockstep mode: the exchange is recoverable — resend it
                    # (as a snapshot of the shadow if it was a delta) once
                    # the reconnect loop lands on a live server
                    retry = self._encoder.resync_job(job)
                    if retry is not None:
                        pending = retry
                        self.retried_exchanges += 1
                        self._note_error(
                            f"exchange interrupted ({type(e).__name__}: {e});"
                            " retrying as full snapshot")
                        continue
                pending = None
                self._encoder.invalidate()   # server shadow died with the
                self.drops += 1              # connection
                self._note_error(f"exchange dropped ({type(e).__name__}: {e})")
                self._post_failure(job.gen)
                continue
            except Exception as e:  # noqa: BLE001 — the lane must never die
                # silently: an encode/decode bug (e.g. a >4GiB frame
                # overflowing the u32 length, or an unflatten mismatch)
                # would otherwise kill this daemon thread and leave training
                # in permanent SGD fallback with a forever-full job queue
                pending = None
                self.drops += 1
                self._note_error(
                    f"exchange failed ({type(e).__name__}: {e})")
                self._post_failure(job.gen)
                self._drop_socket()
                self._encoder.invalidate()
                continue
            pending = None
            self.exchanges += 1
            self.timings.append(rtt)
            self.last_rtt_s = rtt
            self.last_wire_in_bytes = in_bytes
            self.last_wire_out_bytes = out_bytes
            self.wire_in_bytes += in_bytes
            self.wire_out_bytes += out_bytes
            self.wire_bytes_per_exchange = in_bytes
            self.last_job_kind = job.kind
            self.job_frame_measured[job.kind] = out_bytes
            meta = {"wire_bytes": float(in_bytes + out_bytes), "rtt_s": rtt,
                    "wire_in_bytes": in_bytes, "wire_out_bytes": out_bytes,
                    "job_bytes": float(out_bytes),
                    "grad_bytes": float(in_bytes),
                    "server_compute_s": compute_s,
                    "client_id": float(self.client_uid)}
            if pool_meta:
                self.last_pool_depth = pool_meta["pool_depth"]
                self.last_pool_wait_s = pool_meta["pool_wait_s"]
                meta["pool_depth"] = float(pool_meta["pool_depth"])
                meta["pool_wait_s"] = float(pool_meta["pool_wait_s"])
            try:
                self._results.put((rgen, g, norm, meta), timeout=1.0)
            except queue.Full:
                pass         # consumer lagging: drop (stale anyway)

    def _post_failure(self, gen: int) -> None:
        """Lost-exchange sentinel (grad=None): releases a lockstep waiter
        immediately instead of letting it sit out the full poll timeout."""
        try:
            self._results.put_nowait((gen, None, 0.0, {}))
        except queue.Full:
            pass


def fetch_pool_stats(addr: str, *, auth_token: str = "",
                     timeout: float = 30.0) -> dict:
    """Scrape one STATS snapshot from a pool server (revision 4) of either
    package.

    Connects as an *observer* (HELLO with `observe`, so the server creates no
    canonical shadow and the scrape never shows up as a training client),
    sends an empty STATS request, and returns the decoded snapshot dict —
    scheduler counters, queue capacity/depth, and the per-client/per-shadow
    detail sections. Raises ProtocolError against a pre-revision-4 server
    (whose ACK declares an older proto) and ConnectionError/OSError on an
    unreachable address; the caller decides whether a failed scrape matters.
    """
    sock = protocol.connect(addr, timeout=timeout)
    try:
        protocol.send_frame(sock, FrameType.HELLO, protocol.encode_hello(
            Compressor(kind="none"), client_id="stats-observer",
            token=auth_token, extra={"observe": True}))
        ftype, payload, _ = protocol.recv_frame(sock, timeout=timeout)
        if ftype == FrameType.ERROR:
            raise ProtocolError(
                f"HELLO refused: {payload.decode(errors='replace')}")
        if ftype != FrameType.HELLO_ACK:
            raise ProtocolError(f"expected HELLO_ACK, got {ftype.name}")
        _, ack = protocol.decode_hello(payload)
        if int(ack.get("proto") or 0) < protocol.STATS_REVISION:
            raise ProtocolError(
                f"server proto {ack.get('proto')} predates the STATS frame "
                f"(revision {protocol.STATS_REVISION})")
        protocol.send_frame(sock, FrameType.STATS, b"")
        ftype, payload, _ = protocol.recv_frame(sock, timeout=timeout)
        if ftype != FrameType.STATS:
            raise ProtocolError(f"expected STATS, got {ftype.name}")
        return protocol.decode_stats(payload)
    finally:
        try:
            sock.close()
        except OSError:
            pass
