"""netchaos: a frame-aware TCP chaos proxy for the ascent wire (counterpart
of `repro.service.netchaos`, plain Python over the port's `service.protocol`,
which frames the same bytes).

Sits between `RemoteAscentClient` and an ascent server/pool and attacks the
connection at the protocol-frame level, driven by a seeded, deterministic
`FaultSchedule`. Where `runtime.chaos` injects mesh-level events (device
loss, preemption), this module injects wire-level ones — the two harnesses
together cover both failure domains the ROADMAP cares about.

The proxy understands the `service.protocol` framing (16-byte header +
payload), so faults are *per frame kind*: a schedule can corrupt every GRAD,
stall the 3rd JOB_DELTA mid-frame, or blackhole the server->client direction
for 300ms — each of which lands on a different hardening path in the client
(crc drop, reconnect+retry, staleness ledger) and, above it, the
`runtime.health` degradation ladder.

Fault actions:

    corrupt     flip a payload byte and forward — the receiver's crc32 check
                rejects the frame (ProtocolError -> drop/reconnect path)
    truncate    forward the header + half the payload, then kill the link —
                the receiver sees EOF mid-frame (ConnectionError)
    drop        kill the link without forwarding the frame
    delay       sleep `delay_s`, then forward intact (transient: the
                exchange completes, late)
    stall       forward half the frame, sleep `delay_s`, forward the rest
                (transient mid-frame hiccup: completes)
    blackhole   swallow the frame and go silent for `duration_s`, then kill
                the link — the receiver gets neither data nor an error until
                the link dies (the failure mode only `LaneHealth.stalled()`
                or the eventual connection loss can catch)
    duplicate   forward the frame twice (sequence skew: exercises the
                server-side replay / RESYNC guards)

Rules fire deterministically (`nth`/`every`/`count`) or probabilistically
from a seeded `random.Random`, so a schedule replays identically run to run.

    schedule = parse_faults("corrupt:GRAD:nth=2,drop:JOB_DELTA:nth=5")
    with ChaosProxy(server.addr, schedule) as proxy:
        cfg = ExecutorConfig(ascent_addr=proxy.addr, ...)

The launcher exposes the same spec grammar as `--netchaos SPEC` for local
soak runs.
"""
from __future__ import annotations

import dataclasses
import random
import socket
import threading
import time
from typing import Optional

from repro_torch.service import protocol
from repro_torch.service.protocol import FRAME_HEADER_BYTES

FAULT_ACTIONS = ("corrupt", "truncate", "drop", "delay", "stall",
                 "blackhole", "duplicate")


@dataclasses.dataclass
class FaultRule:
    """One line of a schedule: which frames, which fault, when.

    A rule *matches* frames by kind and direction; among its matches it
    *fires* on the `nth` match (1-based), on every `every`-th match, with
    probability `prob`, or — when none of those are set — on every match.
    `count` bounds total firings (-1 = unlimited), so a hostile opening can
    give way to a clean tail the ladder can recover into.
    """

    action: str
    frame: str = "*"           # FrameType name ("GRAD", "JOB_DELTA", ...) | "*"
    direction: str = "*"       # "c2s" | "s2c" | "*"
    nth: int = 0               # fire on the nth matching frame (1-based)
    every: int = 0             # fire on every k-th matching frame
    prob: float = 0.0          # fire with this probability per match
    delay_s: float = 0.05      # delay / stall sleep
    duration_s: float = 0.25   # blackhole silence window
    count: int = -1            # max firings; -1 = unlimited
    seen: int = 0              # matching frames observed (mutable state)
    fired: int = 0             # times this rule fired (mutable state)

    def __post_init__(self):
        if self.action not in FAULT_ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {FAULT_ACTIONS})")

    def matches(self, direction: str, frame_name: str) -> bool:
        return ((self.frame == "*" or self.frame == frame_name)
                and (self.direction == "*" or self.direction == direction))

    def should_fire(self, rng: random.Random) -> bool:
        """Call once per matching frame (advances the match counter)."""
        self.seen += 1
        if self.count >= 0 and self.fired >= self.count:
            return False
        if self.nth:
            fire = self.seen == self.nth
        elif self.every:
            fire = self.seen % self.every == 0
        elif self.prob:
            fire = rng.random() < self.prob
        else:
            fire = True
        if fire:
            self.fired += 1
        return fire


class FaultSchedule:
    """Ordered fault rules + one seeded RNG; first firing rule wins."""

    def __init__(self, rules: list, seed: int = 0):
        self.rules = list(rules)
        self.rng = random.Random(seed)
        self._lock = threading.Lock()

    def fire(self, direction: str, frame_name: str) -> Optional[FaultRule]:
        """The rule that fires for this frame, or None to pass it through.

        Locked: the proxy runs one pump thread per direction per link, and
        rule counters must advance deterministically across all of them.
        """
        with self._lock:
            for rule in self.rules:
                if rule.matches(direction, frame_name) \
                        and rule.should_fire(self.rng):
                    return rule
        return None

    def fired_actions(self) -> dict:
        with self._lock:
            out: dict = {}
            for r in self.rules:
                out[r.action] = out.get(r.action, 0) + r.fired
            return out


_FLOAT_KEYS = ("prob", "delay_s", "duration_s")
_INT_KEYS = ("nth", "every", "count")


def parse_faults(spec: str, seed: int = 0) -> FaultSchedule:
    """Parse a schedule spec: comma-separated `action[:FRAME][:key=val...]`.

        "corrupt:GRAD:nth=2,delay:*:prob=0.2:delay_s=0.1,drop:HELLO"

    Mirrors `runtime.chaos.parse_schedule`'s grammar style so the two
    launcher flags (`--chaos` / `--netchaos`) read the same way.
    """
    rules = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        fields = part.split(":")
        kwargs: dict = {"action": fields[0]}
        for field in fields[1:]:
            if "=" in field:
                key, _, val = field.partition("=")
                if key in _FLOAT_KEYS:
                    kwargs[key] = float(val)
                elif key in _INT_KEYS:
                    kwargs[key] = int(val)
                elif key == "direction":
                    kwargs[key] = val
                else:
                    raise ValueError(f"unknown fault option {key!r} in "
                                     f"{part!r}")
            else:
                kwargs["frame"] = field
        rules.append(FaultRule(**kwargs))
    return FaultSchedule(rules, seed=seed)


class _Link:
    """One proxied client connection: a socket pair + its two pump threads."""

    def __init__(self, client: socket.socket, server: socket.socket):
        self.client = client
        self.server = server
        self._dead = threading.Event()

    def kill(self) -> None:
        """Tear both sides down (idempotent); both pumps exit on the error."""
        self._dead.set()
        for sock in (self.client, self.server):
            try:
                sock.close()
            except OSError:
                pass

    @property
    def dead(self) -> bool:
        return self._dead.is_set()


class ChaosProxy:
    """Frame-aware TCP proxy applying a `FaultSchedule` to the ascent wire.

    Accepts any number of client connections (reconnects included — that is
    half the point), dials `upstream` per connection, and pumps whole
    protocol frames in both directions through the schedule. Counters
    (`connections`, `frames`, `faults`) are observable for assertions.
    """

    def __init__(self, upstream: str, schedule: Optional[FaultSchedule] = None,
                 *, bind: str = "127.0.0.1:0", dial_timeout_s: float = 10.0):
        self.upstream = upstream
        self.schedule = schedule or FaultSchedule([])
        self.dial_timeout_s = dial_timeout_s
        self._listener, self.addr = protocol.bind_listener(bind, backlog=16)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._links: list = []
        self.connections = 0            # accepted client connections
        self.frames: dict = {}          # (direction, frame name) -> forwarded
        self.faults: list = []          # (direction, frame name, action) log
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # --- plumbing --------------------------------------------------------------
    def _accept_loop(self) -> None:
        self._listener.settimeout(0.2)
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break       # listener closed under us (close())
            with self._lock:
                self.connections += 1
            try:
                server = protocol.connect(self.upstream,
                                          timeout=self.dial_timeout_s)
            except OSError:
                try:
                    client.close()   # upstream gone: the client sees a drop
                except OSError:
                    pass
                continue
            link = _Link(client, server)
            with self._lock:
                self._links.append(link)
            for direction, src, dst in (("c2s", client, server),
                                        ("s2c", server, client)):
                threading.Thread(target=self._pump,
                                 args=(link, direction, src, dst),
                                 daemon=True).start()

    def _pump(self, link: _Link, direction: str, src: socket.socket,
              dst: socket.socket) -> None:
        """Read whole frames off `src`, run them through the schedule, and
        forward to `dst`; any socket/frame error kills the link (both pumps
        exit — a half-proxied connection is worse than a dead one)."""
        try:
            while not self._stop.is_set() and not link.dead:
                header = protocol.recv_exact(src, FRAME_HEADER_BYTES,
                                             stop=self._stop)
                ftype, length, _crc = protocol.decode_frame_header(header)
                payload = protocol.recv_exact(src, length, stop=self._stop)
                rule = self.schedule.fire(direction, ftype.name)
                if rule is not None:
                    with self._lock:
                        self.faults.append((direction, ftype.name,
                                            rule.action))
                    if self._apply(rule, link, dst, header, payload):
                        continue        # frame handled (or link killed)
                # count before forwarding: once the peer can observe the
                # frame, the counter must already reflect it
                with self._lock:
                    key = (direction, ftype.name)
                    self.frames[key] = self.frames.get(key, 0) + 1
                dst.sendall(header + payload)
        except (OSError, ConnectionError, TimeoutError,
                protocol.ProtocolError):
            pass
        finally:
            link.kill()

    def _apply(self, rule: FaultRule, link: _Link, dst: socket.socket,
               header: bytes, payload: bytes) -> bool:
        """Apply one fault. Returns True when the frame was consumed here
        (forwarded mutated, duplicated, or the link was killed); False to
        fall through to the normal forward."""
        action = rule.action
        if action == "corrupt":
            if payload:
                bad = bytearray(payload)
                bad[len(bad) // 2] ^= 0xFF
                dst.sendall(header + bytes(bad))
            else:
                # no payload to flip: corrupt the header's crc field instead
                bad = bytearray(header)
                bad[-1] ^= 0xFF
                dst.sendall(bytes(bad))
            return True
        if action == "truncate":
            dst.sendall(header + payload[:len(payload) // 2])
            link.kill()
            return True
        if action == "drop":
            link.kill()
            return True
        if action == "delay":
            time.sleep(rule.delay_s)
            return False                # forward intact, late
        if action == "stall":
            cut = (FRAME_HEADER_BYTES + len(payload)) // 2
            buf = header + payload
            dst.sendall(buf[:cut])
            time.sleep(rule.delay_s)
            dst.sendall(buf[cut:])
            return True
        if action == "blackhole":
            # swallow the frame, hold the link open and silent, then kill it:
            # the receiver sees nothing at all until the connection dies
            self._stop.wait(rule.duration_s)
            link.kill()
            return True
        if action == "duplicate":
            dst.sendall(header + payload)
            dst.sendall(header + payload)
            return True
        raise AssertionError(f"unhandled fault action {action!r}")

    # --- observation / teardown ------------------------------------------------
    def fault_count(self) -> int:
        with self._lock:
            return len(self.faults)

    def kill_links(self) -> None:
        """Drop every live proxied connection (clients will reconnect)."""
        with self._lock:
            links = list(self._links)
        for link in links:
            link.kill()

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.kill_links()
        self._accept_thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
