"""AscentPool — the multi-client scheduler behind the ascent server
(counterpart of `repro.service.pool`, whole: a client of either package can
attach).

A single-connection server carries the paper's claim across a wire for
exactly one descent client talking to one ascent helper; LSAM (arXiv 2509.03110) is the argument that
asynchronous *distributed* SAM — many data-parallel workers sharing a
smoothed ascent signal — is where the approach pays off. This module turns
the one-connection serve loop into that fleet service:

    descent host 1 ──┐                       ┌── worker 1 ─┐
    descent host 2 ──┤  accept ──> bounded   ├── worker 2 ─┼─> ascent fn
        ...          │  threads    work queue│    ...      │   (shared fn)
    descent host N ──┘                       └── worker M ─┘

Three ideas, each replacing a per-connection structure from the old server:

**One canonical shadow per (scope, generation)** — `SharedShadow`. The old
server kept a `ShadowState` per connection; N data-parallel replicas would
each ship their own snapshot and delta stream of the *same* params. The pool
keeps ONE generation-stamped shadow per attach scope (the client's sync
group, or a private scope for ungrouped clients) that every same-scope
client's stream lands on: the first snapshot installs it, every subsequent
identical snapshot is an idempotent skip, and because lockstep DP replicas
emit identical power-of-two-scaled delta streams, a replica's delta that a
peer already applied is served from a short replay ring instead of being
re-applied (the sharing win — the shadow advances once, bitwise-identically,
no matter how many replicas feed it). Streams that genuinely skew fall back
to the RESYNC contract, and a stream whose epoch the canonical shadow
has moved past gets a DETACH carrying the canonical sync so the client can
fast-forward its encoder and re-install above it.

**`global` ascent-sync groups** — `_Group`. Clients registered under the
same HELLO `group` receive a *consistent* ascent gradient per (generation,
step): the first job to arrive computes it (under the group lock, with the
group's own error-feedback state), an LSAM-style EMA smooths it across
steps, and a small keyed cache hands the same smoothed leaves to every other
group member asking for that (generation, step) — so all DP replicas perturb
coherently instead of each chasing its own noisy ascent direction.

**Bounded admission with BUSY backpressure.** Jobs are admitted to a
bounded queue served by M workers; when the queue is full the client gets a
BUSY frame instead of unbounded buffering — it treats the exchange as failed
and falls back to its staleness ledger, exactly the paper's depth-1
semantics generalized to N clients. Shadow deltas are applied BEFORE the
admission check, so a BUSY rejection costs the compute but never desyncs the
delta stream.

Hardening for non-loopback listeners: shared-token auth at HELLO (wrong or
missing token draws an immediate ERROR and a closed socket), per-client recv
idle deadlines and whole-frame send deadlines, and per-client error
isolation — a connection that speaks garbage, wedges, or dies is dropped
without touching the queue, the workers, or any other client.

The workers share one ascent function (`core.make_ascent_fn`; each exchange
builds its own autograd graph) on the server's device. Each worker records a
`pool_exchange` span per job on its own track of the current tracker
(`repro_torch.obs`).
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
import zlib
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core import make_ascent_fn
from repro_torch.obs import current_tracker
from repro_torch.runtime.async_executor import ascent_exchange
from repro_torch.service import protocol
from repro_torch.service.delta import ShadowState
from repro_torch.service.protocol import FrameType, ProtocolError
from repro_torch.utils import buckets, trees

Pytree = Any


def client_uid(client_id: str) -> int:
    """Stable numeric form of a client id for float-coerced telemetry.

    `StalenessTelemetry` coerces every optional metric through float(), so
    the jsonl `client_id` field is crc32 of the declared string id (or the
    integer itself when the id is already numeric)."""
    cid = str(client_id)
    if cid.isdigit():
        return int(cid)
    return zlib.crc32(cid.encode())


@dataclasses.dataclass
class PoolConfig:
    """Scheduler knobs for one AscentPool."""
    workers: int = 1              #: M concurrent ascent workers
    queue_depth: int = 4          #: admission bound before BUSY
    auth_token: str = ""          #: shared secret; "" disables auth
    hello_timeout_s: float = 30.0
    idle_timeout_s: float = 600.0  #: per-client recv deadline between jobs
    send_timeout_s: float = 120.0  #: whole-frame send budget per client
    shadow_history: int = 4       #: replay-ring depth per canonical shadow
    smooth_beta: float = 0.9      #: LSAM-style group-gradient EMA (0 = off)
    group_cache: int = 8          #: (gen, step) entries kept per group
    delay_s: float = 0.0          #: injected straggle (tests/benchmarks)
    legacy_hello: bool = False    #: behave like a revision-1 server


class SharedShadow:
    """One canonical generation-stamped shadow many delta streams land on.

    Wraps `delta.ShadowState` (strict sync/seq gating, validate-before-
    apply) with the multi-writer dispositions: idempotent snapshot skips, a
    replay ring of the last `history` post-delta params (owned copies — the
    live buffers keep mutating under later deltas), and the DETACH signal
    for a stream whose sync epoch the canonical shadow has moved past.
    All dispositions run under one lock; the params trees handed back are
    cut from owned buffers, safe to read while the shadow advances.
    """

    def __init__(self, history: int = 4):
        self._state = ShadowState()
        self._lock = threading.Lock()
        self._history = max(1, int(history))
        self._ring: "collections.OrderedDict[int, list]" = \
            collections.OrderedDict()     # seq -> owned fp32 bucket buffers
        self.installs = 0
        self.skips = 0
        self.deltas_applied = 0
        self.replays = 0

    @property
    def sync(self) -> int:
        return self._state.sync

    @property
    def seq(self) -> int:
        return self._state.seq

    def bufs_copy(self) -> Optional[list]:
        """Owned copy of the current shadow buffers (test introspection)."""
        with self._lock:
            if self._state.bufs is None:
                return None
            return [b.copy() for b in self._state.bufs]

    def _cut(self, bufs: list) -> Pytree:
        return buckets.host_buckets_to_tree(bufs, self._state.layout,
                                            self._state.leaf_dtypes)

    def _record(self, seq: int) -> None:
        self._ring[seq] = [b.copy() for b in self._state.bufs]
        while len(self._ring) > self._history:
            self._ring.popitem(last=False)

    def take_snapshot(self, params: Pytree, sync: int) -> str:
        """-> "install" | "skip". The job computes from the frame's own
        params either way; only the canonical shadow bookkeeping differs."""
        with self._lock:
            st = self._state
            if st.bufs is None or int(sync) > st.sync:
                st.install(params, sync)
                self._ring.clear()
                self.installs += 1
                return "install"
            # same-or-older sync: a replica re-declaring the install the
            # first member already made (lockstep DP), a late joiner whose
            # peer's deltas advanced the shadow, or a stale stream that will
            # draw a DETACH on its first delta — never roll back
            self.skips += 1
            return "skip"

    def take_delta(self, kind: str, sections: list, sync: int,
                   seq: int) -> tuple:
        """-> ("apply"|"replay", params) | ("resync", reason) |
        ("detach", canonical_sync, reason).

        Raises ProtocolError (caller drops the connection) only for
        structurally damaged sections, with the shadow untouched."""
        with self._lock:
            st = self._state
            if st.bufs is None:
                return ("resync", "no shadow installed")
            if int(sync) == st.sync:
                if int(seq) == st.seq + 1:
                    st.apply(kind, sections, sync, seq)
                    self.deltas_applied += 1
                    self._record(int(seq))
                    return ("apply", self._cut(self._ring[int(seq)]))
                if int(seq) in self._ring:
                    # a lockstep peer already advanced the shadow through
                    # this seq; serve the recorded post-delta params without
                    # re-applying — the canonical shadow advances once
                    self.replays += 1
                    return ("replay", self._cut(self._ring[int(seq)]))
                return ("resync",
                        f"shadow at (sync={st.sync}, seq={st.seq}) cannot "
                        f"take (sync={sync}, seq={seq})")
            if int(sync) < st.sync:
                return ("detach", st.sync,
                        f"shadow epoch moved to sync={st.sync}, past this "
                        f"stream's sync={sync}")
            return ("resync",
                    f"shadow at sync={st.sync} never saw install "
                    f"sync={sync}")


class _Group:
    """Shared ascent-gradient state for one `global` sync group."""

    def __init__(self, beta: float, cache_size: int):
        self.lock = threading.Lock()
        self.beta = float(beta)
        self.cache_size = max(1, int(cache_size))
        self.cache: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()   # (gen, step) -> (leaves, norm, dt)
        self.smoothed: Optional[list] = None   # EMA leaves (np fp32)
        self.comp_state = None                 # group error-feedback state
        self.hits = 0
        self.computes = 0


@dataclasses.dataclass
class _Work:
    """One admitted exchange, queued for a pool worker."""
    client: "_ClientConn"
    gen: int
    step: int
    params: Pytree
    batch: Pytree
    rng: Any
    enq_t: float
    depth: int          # queue depth observed at admission


class _ClientConn:
    """One accepted connection's identity + framed-send discipline."""

    _anon = 0
    _anon_lock = threading.Lock()

    def __init__(self, conn, compressor, meta: dict):
        self.conn = conn
        self.compressor = compressor
        self.send_lock = threading.Lock()
        self.alive = True
        cid = str(meta.get("client_id") or "")
        if not cid:
            with _ClientConn._anon_lock:
                _ClientConn._anon += 1
                cid = f"anon-{_ClientConn._anon}"
        self.client_id = cid
        self.group = str(meta.get("group") or "")
        self.generation = int(meta.get("generation") or 0)
        self.proto = int(meta.get("proto") or 0)
        #: a stats observer connects only to scrape (no shadow, no jobs)
        self.observer = bool(meta.get("observe"))
        # per-client scheduler telemetry, served in the STATS snapshot
        self.exchanges = 0
        self.last_wait_s = 0.0

    @property
    def pool_grad(self) -> bool:
        """Whether GRAD frames to this client carry the pool prelude."""
        return self.proto >= protocol.POOL_REVISION

    @property
    def scope(self) -> str:
        """The canonical-shadow attach scope: the sync group, or a private
        per-identity scope for ungrouped clients (same-id reconnects land on
        the same shadow; anonymous connections get a fresh one)."""
        return self.group if self.group else f"client:{self.client_id}"

    def send(self, ftype: FrameType, payload: bytes,
             timeout: Optional[float]) -> int:
        with self.send_lock:
            return protocol.send_frame_deadline(self.conn, ftype, payload,
                                                timeout)

    def close(self) -> None:
        self.alive = False
        try:
            self.conn.close()
        except OSError:
            pass


class AscentPool:
    """Scheduler: N client connections -> bounded queue -> M ascent workers.

    Owns the ascent function (shared across workers: each call builds its
    own graph), the canonical shadows, the sync groups,
    and every counter the server reports. `attach(conn)` is the only entry
    point the accept loop needs; everything after that is per-client
    isolated.
    """

    def __init__(self, loss_fn: Callable, cfg: Optional[PoolConfig] = None,
                 *, device=None):
        self.cfg = cfg or PoolConfig()
        self._ascent = make_ascent_fn(loss_fn)
        self._norm = trees.global_norm
        self.device = device
        self._stop = threading.Event()
        self._queue: "queue.Queue[_Work]" = queue.Queue(
            maxsize=max(1, self.cfg.queue_depth))
        self._lock = threading.Lock()          # registries + counters
        self._clients: set = set()
        self._shadows: dict = {}               # (scope, gen) -> SharedShadow
        self._groups: dict = {}                # name -> _Group
        self._comp_states: dict = {}           # stream key -> comp_state
        self._threads: list = []
        # counters (all mutated under self._lock or single-writer)
        self.connections = 0
        self.exchanges = 0
        self.resyncs_sent = 0
        self.detaches_sent = 0
        self.busy_rejections = 0
        self.auth_rejections = 0
        self.server_errors = 0
        self.dropped_clients = 0
        self.orphaned_jobs = 0
        self._workers = [threading.Thread(target=self._worker_loop,
                                          name=f"ascent-worker-{i}",
                                          daemon=True)
                         for i in range(max(1, self.cfg.workers))]
        for w in self._workers:
            w.start()

    # --- registries --------------------------------------------------------

    def _shadow_for(self, scope: str, gen: int) -> SharedShadow:
        with self._lock:
            key = (scope, int(gen))
            shadow = self._shadows.get(key)
            if shadow is None:
                shadow = self._shadows[key] = SharedShadow(
                    self.cfg.shadow_history)
                # retire shadows of older generations in this scope: a gen
                # bump (executor reset) invalidates their epoch for good
                for old in [k for k in self._shadows
                            if k[0] == scope and k[1] < int(gen)]:
                    del self._shadows[old]
            return shadow

    def _group_for(self, name: str) -> _Group:
        with self._lock:
            grp = self._groups.get(name)
            if grp is None:
                grp = self._groups[name] = _Group(self.cfg.smooth_beta,
                                                  self.cfg.group_cache)
            return grp

    def stats(self) -> dict:
        """Counter snapshot (also printed as the exit stats line)."""
        with self._lock:
            shadow_installs = sum(s.installs for s in self._shadows.values())
            shadow_skips = sum(s.skips for s in self._shadows.values())
            deltas_applied = sum(s.deltas_applied
                                 for s in self._shadows.values())
            delta_replays = sum(s.replays for s in self._shadows.values())
            group_hits = sum(g.hits for g in self._groups.values())
            group_computes = sum(g.computes for g in self._groups.values())
            return {
                "connections": self.connections,
                "clients": len(self._clients),
                "exchanges": self.exchanges,
                "busy_rejections": self.busy_rejections,
                "auth_rejections": self.auth_rejections,
                "resyncs_sent": self.resyncs_sent,
                "detaches_sent": self.detaches_sent,
                "shadow_installs": shadow_installs,
                "shadow_skips": shadow_skips,
                "deltas_applied": deltas_applied,
                "delta_replays": delta_replays,
                "shadows": len(self._shadows),
                "group_hits": group_hits,
                "group_computes": group_computes,
                "server_errors": self.server_errors,
                "dropped_clients": self.dropped_clients,
                "orphaned_jobs": self.orphaned_jobs,
            }

    def stats_snapshot(self) -> dict:
        """The full STATS-frame snapshot: `stats()` counters plus scheduler
        capacity and the per-client / per-shadow detail sections a fleet
        observer joins against its own jsonl traces (client uids match the
        `client_id` metric). Observer connections are excluded from the
        detail — a scraper must not see itself as a training client."""
        snap = self.stats()
        snap["workers"] = len(self._workers)
        snap["queue_capacity"] = self._queue.maxsize
        snap["queue_depth"] = self._queue.qsize()
        with self._lock:
            snap["clients_detail"] = [
                {"uid": client_uid(c.client_id),
                 "group_uid": client_uid(c.group) if c.group else 0,
                 "exchanges": c.exchanges,
                 "last_wait_s": c.last_wait_s}
                for c in sorted(self._clients, key=lambda c: c.client_id)
                if not c.observer]
            snap["shadows_detail"] = [
                {"scope_uid": client_uid(scope), "gen": gen,
                 "sync": shadow.sync, "seq": shadow.seq,
                 "replays": shadow.replays}
                for (scope, gen), shadow in sorted(self._shadows.items())]
        return snap

    # --- accept-side -------------------------------------------------------

    def attach(self, conn) -> threading.Thread:
        """Hand one accepted socket to its own handler thread."""
        with self._lock:
            self.connections += 1
        t = threading.Thread(target=self._serve_client, args=(conn,),
                             name="ascent-client", daemon=True)
        with self._lock:
            self._threads.append(t)
            self._threads = [x for x in self._threads if x.is_alive()][-64:]
        t.start()
        return t

    def _serve_client(self, conn) -> None:
        client: Optional[_ClientConn] = None
        try:
            ftype, payload, _ = protocol.recv_frame(
                conn, stop=self._stop, timeout=self.cfg.hello_timeout_s)
            if ftype != FrameType.HELLO:
                raise ProtocolError(f"expected HELLO, got {ftype.name}")
            compressor, hello = protocol.decode_hello(payload)
            if self.cfg.auth_token and \
                    hello.get("token") != self.cfg.auth_token:
                with self._lock:
                    self.auth_rejections += 1
                protocol.send_frame_deadline(
                    conn, FrameType.ERROR,
                    b"auth-rejected: bad or missing token",
                    self.cfg.send_timeout_s)
                return
            client = _ClientConn(conn, compressor, hello)
            if self.cfg.legacy_hello:
                # a revision-1 server never sends the pool GRAD prelude, no
                # matter what revision the client declared
                client.proto = 0
            with self._lock:
                self._clients.add(client)
            if self.cfg.legacy_hello:
                ack = protocol.encode_hello(compressor, proto=None)
            elif client.observer:
                # stats scrapers get no canonical shadow: they never send
                # jobs, and creating one would pin an empty (scope, gen)
                # entry in the registry the STATS reply then reports
                ack = protocol.encode_hello(
                    compressor, proto=protocol.PROTO_REVISION,
                    extra={"pool_workers": len(self._workers),
                           "queue_depth": self._queue.maxsize,
                           "shadow_sync": 0})
            else:
                shadow = self._shadow_for(client.scope, client.generation)
                ack = protocol.encode_hello(
                    compressor, proto=protocol.PROTO_REVISION,
                    extra={"pool_workers": len(self._workers),
                           "queue_depth": self._queue.maxsize,
                           "shadow_sync": shadow.sync})
            client.send(FrameType.HELLO_ACK, ack, self.cfg.send_timeout_s)
            self._client_loop(client)
        except (ConnectionError, ProtocolError, OSError, TimeoutError):
            pass            # client went away / spoke garbage / idled out
        except Exception as e:  # noqa: BLE001 — one bad connection must
            # never take down the pool; log and move on
            print(f"ascent-pool: connection failed: "
                  f"{type(e).__name__}: {e}", flush=True)
        finally:
            if client is not None:
                with self._lock:
                    self._clients.discard(client)
                    if not self._stop.is_set():
                        self.dropped_clients += 1
                client.close()
            else:
                try:
                    conn.close()
                except OSError:
                    pass

    def _client_loop(self, client: _ClientConn) -> None:
        while not self._stop.is_set():
            try:
                ftype, payload, _ = protocol.recv_frame(
                    client.conn, stop=self._stop,
                    timeout=self.cfg.idle_timeout_s)
            except ConnectionAbortedError:
                return       # pool stop while waiting for the next job
            if ftype == FrameType.JOB:
                try:
                    gen, step, params, batch, rng = \
                        protocol.decode_job(payload)
                except Exception as e:
                    raise ProtocolError(
                        f"malformed JOB payload ({type(e).__name__}: {e})"
                    ) from e
            elif ftype == FrameType.JOB_DELTA and not self.cfg.legacy_hello:
                try:
                    (sync, seq, gen, step, kind, params, batch, rng,
                     sections) = protocol.decode_job_v2(payload)
                except ProtocolError:
                    raise
                except Exception as e:
                    raise ProtocolError(
                        f"malformed JOB_DELTA payload "
                        f"({type(e).__name__}: {e})") from e
                shadow = self._shadow_for(client.scope, gen)
                if kind == "snapshot":
                    if sync:          # sync == 0: stateless, no stream
                        shadow.take_snapshot(params, sync)
                    # compute from the frame's own params either way
                else:
                    verdict = shadow.take_delta(kind, sections, sync, seq)
                    if verdict[0] == "resync":
                        with self._lock:
                            self.resyncs_sent += 1
                        client.send(FrameType.RESYNC,
                                    protocol.encode_resync(verdict[1],
                                                           shadow.sync),
                                    self.cfg.send_timeout_s)
                        continue
                    if verdict[0] == "detach":
                        with self._lock:
                            self.detaches_sent += 1
                        client.send(FrameType.DETACH,
                                    protocol.encode_resync(verdict[2],
                                                           verdict[1]),
                                    self.cfg.send_timeout_s)
                        continue
                    params = verdict[1]       # "apply" or "replay"
            elif ftype == FrameType.STATS and not self.cfg.legacy_hello:
                # revision-4 scrape: reply with the fixed-layout snapshot
                # and wait for the next request on the same socket
                client.send(FrameType.STATS,
                            protocol.encode_stats(self.stats_snapshot()),
                            self.cfg.send_timeout_s)
                continue
            else:
                raise ProtocolError(f"expected JOB, got {ftype.name}")
            # admission AFTER the shadow work: a BUSY rejection loses the
            # compute, never the delta-stream alignment
            depth = self._queue.qsize()
            work = _Work(client=client, gen=gen, step=step, params=params,
                         batch=batch, rng=rng, enq_t=time.monotonic(),
                         depth=depth)
            try:
                self._queue.put_nowait(work)
            except queue.Full:
                with self._lock:
                    self.busy_rejections += 1
                client.send(FrameType.BUSY,
                            protocol.encode_busy(depth, gen, step),
                            self.cfg.send_timeout_s)

    # --- worker-side -------------------------------------------------------

    def _compute(self, client: _ClientConn, work: _Work) -> tuple:
        """-> (leaves, norm, compute_time_s) for one job, group-aware."""
        if client.group:
            grp = self._group_for(client.group)
            with grp.lock:
                key = (work.gen, work.step)
                hit = grp.cache.get(key)
                if hit is not None:
                    grp.hits += 1
                    return hit
                t0 = time.perf_counter()
                g, norm, _wire, grp.comp_state = ascent_exchange(
                    self._ascent, self._norm, client.compressor,
                    grp.comp_state, work.params, work.batch,
                    np.asarray(work.rng), device=self.device,
                    delay_s=self.cfg.delay_s)
                leaves = [np.asarray(x, dtype=np.float32)
                          for x in buckets.host_flatten(g)[0]]
                beta = grp.beta
                if grp.smoothed is not None and 0.0 < beta < 1.0 and \
                        len(grp.smoothed) == len(leaves) and \
                        all(o.shape == n.shape
                            for o, n in zip(grp.smoothed, leaves)):
                    leaves = [np.asarray(beta * o + (1.0 - beta) * n,
                                         dtype=np.float32)
                              for o, n in zip(grp.smoothed, leaves)]
                    norm = float(np.sqrt(sum(
                        float(np.sum(np.square(l, dtype=np.float64)))
                        for l in leaves)))
                grp.smoothed = leaves
                grp.computes += 1
                entry = (leaves, float(norm), time.perf_counter() - t0)
                grp.cache[key] = entry
                while len(grp.cache) > grp.cache_size:
                    grp.cache.popitem(last=False)
                return entry
        # ungrouped: a private error-feedback stream per client identity,
        # the exact single-client math (lockstep parity depends on it)
        key = client.client_id
        with self._lock:
            comp_state = self._comp_states.get(key)
        t0 = time.perf_counter()
        g, norm, _wire, comp_state = ascent_exchange(
            self._ascent, self._norm, client.compressor, comp_state,
            work.params, work.batch, np.asarray(work.rng),
            device=self.device, delay_s=self.cfg.delay_s)
        with self._lock:
            self._comp_states[key] = comp_state
        return (buckets.host_flatten(g)[0], float(norm), time.perf_counter() - t0)

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                work = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            client = work.client
            if not client.alive:
                with self._lock:
                    self.orphaned_jobs += 1
                continue
            wait_s = time.monotonic() - work.enq_t
            pool = (work.depth, wait_s) if client.pool_grad else None
            try:
                with current_tracker().span(
                        "pool_exchange",
                        lane=threading.current_thread().name,
                        client_id=client.client_id, group=client.group,
                        gen=work.gen, step=work.step,
                        wait_s=round(wait_s, 6)):
                    leaves, norm, dt = self._compute(client, work)
                payload = protocol.encode_grad(
                    work.gen, work.step, norm, dt, leaves,
                    client.compressor, pool=pool)
            except Exception as e:  # noqa: BLE001 — surfaced to the client,
                # never fatal to the worker slot
                with self._lock:
                    self.server_errors += 1
                try:
                    client.send(FrameType.ERROR,
                                f"{type(e).__name__}: {e}".encode(),
                                self.cfg.send_timeout_s)
                except (OSError, TimeoutError):
                    client.close()
                continue
            try:
                client.send(FrameType.GRAD, payload,
                            self.cfg.send_timeout_s)
                with self._lock:
                    self.exchanges += 1
                    client.exchanges += 1
                    client.last_wait_s = wait_s
            except (OSError, TimeoutError):
                client.close()   # the handler thread's recv will notice

    # --- shutdown ----------------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            clients = list(self._clients)
        for client in clients:
            client.close()
        for w in self._workers:
            w.join(timeout=2.0)
