"""AscentServer — the slow-resource half of AsyncSAM as a standalone process
(counterpart of `repro.service.ascent_server`).

    python -m repro_torch.service.ascent_server \
        --loss repro_torch.service.testing:mlp_loss
    python -m repro_torch.service.ascent_server --loss arch:olmo-1b:reduced \
        --bind 0.0.0.0:7431 --device cpu --pool-workers 4 \
        --auth-token "$ASAM_TOKEN"

The server holds the loss function (resolved from an import path or an
architecture id of the port's registry), runs `core.make_ascent_fn` on its
device (`--device`; the card unless told otherwise, as every entry point of
the port), and answers JOB/JOB_DELTA frames with GRAD frames. The per-exchange math is exactly
`runtime.async_executor.ascent_exchange` — the same function the in-process
thread lane runs — so a loopback remote run reproduces the hetero lane's
hand-off values bit for bit (compressor "none"/"topk"; one rounding ulp for
"int8").

The serve core is `service.pool.AscentPool`:
a threaded accept loop hands each connection to its own handler, jobs are
admitted into a bounded queue served by `--pool-workers` ascent workers, and
per-connection shadow state is replaced by one canonical generation-stamped
shadow per attach scope (see pool.py). Backpressure stays structural: each
client keeps a depth-1 job queue (the paper's depth-1 MPI exchange), and the
pool's bounded admission answers BUSY instead of buffering, so a saturated
helper shows up as staleness (tau growth) or ledger fallback on the clients,
never as unbounded memory.

On startup the server prints ``ascent-server listening on <addr>`` to
stdout; `spawn_server` uses that sentinel to implement the loopback mode
(server as a local subprocess) that `--serve-ascent` and the service tests
drive. On shutdown it prints its peak device memory (on the card) and one
``ascent-pool stats {...}`` JSON line — the
subprocess tests read it from the handle's tail to assert pool behavior
(canonical-shadow sharing, BUSY counts) without introspecting the process.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Optional, Union

import torch

from repro_torch.service import protocol
from repro_torch.service.pool import AscentPool, PoolConfig

_LISTEN_SENTINEL = "ascent-server listening on "
_STATS_SENTINEL = "ascent-pool stats "


def resolve_loss(spec: str) -> Callable:
    """Loss-function lookup: "module:attr" or "arch:NAME[:reduced]"."""
    if spec.startswith("arch:"):
        parts = spec.split(":")
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        cfg = get_config(parts[1], reduced="reduced" in parts[2:])
        return build_model(cfg).loss_fn
    mod, _, attr = spec.partition(":")
    if not mod or not attr:
        raise ValueError(f"loss spec {spec!r} is not 'module:attr' or "
                         "'arch:NAME[:reduced]'")
    return getattr(importlib.import_module(mod), attr)


def parse_device(spec: str) -> torch.device:
    """'cpu', 'cuda', 'cuda:1' ... -> the torch.device ('' is 'cuda'); raises
    for a card that is not there, as the launchers do."""
    from repro_torch.launch.serve import resolve_device
    return resolve_device(spec or "cuda")


class AscentServer:
    """Accept loop + AscentPool: serves N clients with M ascent workers."""

    def __init__(self, loss_fn: Callable, *, bind: str = "127.0.0.1:0",
                 device: Union[str, torch.device] = "cuda", delay_s: float = 0.0,
                 legacy_hello: bool = False, pool_workers: int = 1,
                 queue_depth: int = 4, auth_token: str = "",
                 idle_timeout_s: float = 600.0, smooth_beta: float = 0.9,
                 shadow_history: int = 4):
        cfg = PoolConfig(workers=pool_workers, queue_depth=queue_depth,
                         auth_token=auth_token, idle_timeout_s=idle_timeout_s,
                         smooth_beta=smooth_beta,
                         shadow_history=shadow_history, delay_s=delay_s,
                         legacy_hello=legacy_hello)
        self.pool = AscentPool(loss_fn, cfg, device=parse_device(str(device)))
        self._bind_spec = bind
        self._listener: Optional[socket.socket] = None
        self.address: Optional[str] = None
        self._stop = threading.Event()

    # counter views (the pre-pool server kept these as plain attributes;
    # tests and telemetry read them by name)
    @property
    def exchanges(self) -> int:
        return self.pool.exchanges

    @property
    def connections(self) -> int:
        return self.pool.connections

    @property
    def resyncs_sent(self) -> int:
        return self.pool.resyncs_sent

    @property
    def shadow_installs(self) -> int:
        return self.pool.stats()["shadow_installs"]

    @property
    def deltas_applied(self) -> int:
        return self.pool.stats()["deltas_applied"]

    def stats(self) -> dict:
        return self.pool.stats()

    def start(self) -> str:
        """Bind + listen; returns the resolved address ("host:port"/"unix:...")."""
        if self._listener is None:
            self._listener, self.address = protocol.bind_listener(
                self._bind_spec, backlog=16)
        return self.address

    def serve_forever(self) -> None:
        self.start()
        while not self._stop.is_set():
            self._listener.settimeout(0.2)
            try:
                conn, _peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self.pool.attach(conn)

    def serve_in_thread(self) -> threading.Thread:
        """Test hook: accept loop on a daemon thread (same-process loopback)."""
        self.start()
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def close(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self._listener = None
        self.pool.close()
        if self.address and self.address.startswith("unix:"):
            try:
                os.unlink(self.address[len("unix:"):])
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Loopback mode: the server as a local subprocess
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServerHandle:
    """A spawned ascent-server subprocess + its advertised address."""
    proc: subprocess.Popen
    addr: str
    loss_spec: str
    tail: "collections.deque[str]"   # last stdout/stderr lines (diagnostics)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self, timeout: float = 10.0) -> None:
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=timeout)

    def stats(self, timeout: float = 10.0) -> Optional[dict]:
        """The pool's exit stats line, parsed from the captured tail.

        Only meaningful after `kill()` (the server prints it on shutdown);
        waits up to `timeout` for the line to land in the tail."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for line in list(self.tail):
                if line.startswith(_STATS_SENTINEL):
                    try:
                        return json.loads(line[len(_STATS_SENTINEL):])
                    except ValueError:
                        return None
            if not self.alive() and time.monotonic() + 0.5 > deadline:
                break
            time.sleep(0.1)
        return None


def spawn_server(loss_spec: str, *, bind: str = "127.0.0.1:0",
                 device: str = "", delay_s: float = 0.0,
                 startup_timeout_s: float = 120.0, pool_workers: int = 0,
                 queue_depth: int = 0, auth_token: str = "",
                 smooth_beta: Optional[float] = None) -> ServerHandle:
    """Start ``python -m repro_torch.service.ascent_server`` and wait for its
    listening sentinel; returns a handle with the connectable address.

    A daemon thread keeps draining the child's stdout afterwards, so a chatty
    server can never block on a full pipe; the last lines are retained on the
    handle for post-mortems (including the shutdown stats line). Pool knobs
    at their zero/None defaults are left to the server's own defaults.
    """
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.service.ascent_server",
           "--bind", bind, "--loss", loss_spec]
    if device:
        cmd += ["--device", device]
    if delay_s:
        cmd += ["--delay-s", str(delay_s)]
    if pool_workers:
        cmd += ["--pool-workers", str(pool_workers)]
    if queue_depth:
        cmd += ["--queue-depth", str(queue_depth)]
    if auth_token:
        cmd += ["--auth-token", auth_token]
    if smooth_beta is not None:
        cmd += ["--smooth-beta", str(smooth_beta)]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    tail: collections.deque = collections.deque(maxlen=50)
    addr_box: dict = {}
    sentinel = threading.Event()

    # the reader thread owns the pipe from the start: readline() blocks, so
    # waiting for the sentinel on this thread would defeat startup_timeout_s
    # against a server that wedges silently (e.g. during backend init)
    def _reader(stream):
        for line in stream:
            line = line.rstrip("\n")
            tail.append(line)
            if line.startswith(_LISTEN_SENTINEL) and not sentinel.is_set():
                addr_box["addr"] = line[len(_LISTEN_SENTINEL):].strip()
                sentinel.set()
        stream.close()

    reader = threading.Thread(target=_reader, args=(proc.stdout,), daemon=True)
    reader.start()
    deadline = time.monotonic() + startup_timeout_s
    while time.monotonic() < deadline and not sentinel.is_set():
        if proc.poll() is not None:
            reader.join(timeout=5.0)   # collect the crash output
            break
        sentinel.wait(0.2)
    if "addr" not in addr_box:
        proc.kill()
        raise RuntimeError(
            "ascent server failed to start "
            f"(exit={proc.poll()}):\n" + "\n".join(tail))
    return ServerHandle(proc=proc, addr=addr_box["addr"], loss_spec=loss_spec,
                        tail=tail)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="AsyncSAM ascent-gradient server (paper's slow resource)")
    ap.add_argument("--bind", default="127.0.0.1:0",
                    help="'host:port' (port 0 = kernel-assigned) or "
                         "'unix:/path/to.sock'")
    ap.add_argument("--loss", required=True,
                    help="loss spec: 'module:attr' or 'arch:NAME[:reduced]'")
    ap.add_argument("--device", default="cuda",
                    help="device of the ascent compute: cuda (the kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--delay-s", type=float, default=0.0,
                    help="injected per-exchange delay (straggler emulation)")
    ap.add_argument("--pool-workers", type=int, default=1,
                    help="concurrent ascent workers serving the job queue")
    ap.add_argument("--queue-depth", type=int, default=4,
                    help="admission bound before clients get BUSY")
    ap.add_argument("--auth-token", default="",
                    help="shared secret clients must present in HELLO "
                         "(empty disables auth — loopback only)")
    ap.add_argument("--idle-timeout-s", type=float, default=600.0,
                    help="drop a client that sends no job for this long")
    ap.add_argument("--smooth-beta", type=float, default=0.9,
                    help="LSAM-style EMA coefficient for sync-group "
                         "gradients (0 disables smoothing)")
    ap.add_argument("--legacy-hello", action="store_true",
                    help="test hook: behave like a protocol-revision-1 "
                         "server (no JOB_DELTA support announced or accepted)")
    args = ap.parse_args(argv)

    server = AscentServer(resolve_loss(args.loss), bind=args.bind,
                          device=args.device,
                          delay_s=args.delay_s,
                          legacy_hello=args.legacy_hello,
                          pool_workers=args.pool_workers,
                          queue_depth=args.queue_depth,
                          auth_token=args.auth_token,
                          idle_timeout_s=args.idle_timeout_s,
                          smooth_beta=args.smooth_beta)
    addr = server.start()
    print(f"{_LISTEN_SENTINEL}{addr}", flush=True)
    signal.signal(signal.SIGTERM, lambda *_: server.close())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()
    finally:
        dev = server.pool.device
        if dev.type == "cuda":
            print(f"ascent-server peak device memory {torch.cuda.max_memory_allocated(dev)} "
                  f"bytes allocated, {torch.cuda.max_memory_reserved(dev)} reserved",
                  flush=True)
        print(f"{_STATS_SENTINEL}{json.dumps(server.stats())}", flush=True)


if __name__ == "__main__":
    main()
