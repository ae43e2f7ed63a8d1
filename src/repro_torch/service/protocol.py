"""Wire protocol for the multi-host ascent service (counterpart of
`repro.service.protocol`, byte for byte: a client or server of either package
talks to the other's).

One frame format carries everything that crosses the process boundary:

    0   4  magic  b"ASAM"
    4   1  protocol version (PROTOCOL_VERSION)
    5   1  frame type (FrameType)
    6   2  flags (reserved, 0)
    8   4  payload length, big-endian u32
    12  4  crc32 of the payload
    16  N  payload

Frames out (client -> server): HELLO (compressor config + capability
handshake), JOB (legacy v1: a params snapshot + ascent batch + rng, i.e. the
tuple the in-process lane hands its worker thread), and JOB_DELTA (v2: the
same job with the params direction either a generation-stamped full snapshot
or a delta-encoded update against the server's shadow of the last-synced
params). Frames back: HELLO_ACK, GRAD (the compressed ascent gradient + its
norm + staleness metadata), RESYNC (the server's shadow cannot take this
delta — resend as a full snapshot), and ERROR (server-side exception text).
JOB/HELLO payloads are self-describing (JSON tree spec + raw leaf bytes);
GRAD and the JOB_DELTA bucket sections are fixed-layout binary so their
length is exactly modeled: `grad_frame_bytes(compressor, grad)` /
`job_frame_bytes(encoding, params, batch, rng)` == len of the encoded frame,
with `Compressor.wire_bytes` as the GRAD payload term and the framing/shape
metadata accounted here (the frame-overhead model `Compressor.wire_bytes`
deliberately excludes).

The GRAD encodings mirror `core.ascent.Compressor`'s representations:

    none  fp32 leaves, raw                              4n bytes
    int8  per-leaf f64 scale + int8 payload             n + 8 bytes/leaf
    topk  per-leaf u32 k + k (u32 index, f32 value)     8k + 4 bytes/leaf

so re-encoding the *reconstruction* `Compressor.compress` produced is
lossless for "none"/"topk" and exact up to one rounding ulp for "int8"
(the reconstruction is scale * int8 already).

The JOB_DELTA bucket sections carry the params direction per *dtype bucket*
(`utils.buckets.bucket_layout` grouping — both ends derive the same layout
from the snapshot's tree spec), not per leaf:

    int8  u32 size + f32 scale + int8 payload           n + 8 bytes/bucket
    topk  u32 size + u32 k + k (u32 index, f32 value)   8k + 8 bytes/bucket

HELLO carries `proto`/`job_encodings` capability keys a v1 server ignores
(and whose absence from HELLO_ACK tells a v2 client to degrade to
full-snapshot v1 JOB frames — no codec error mid-fit against an old server).

Trees on the wire are the reference's: nested dicts with sorted keys, per-
block leaves stacked (`models.convert.to_reference`), numpy leaves. The frame
bound `_MAX_PAYLOAD` (2 GiB) is the reference's too, so one snapshot of more
than 2 GiB of parameters (olmo-1b past 6 layers at fp32) cannot be framed by
either package.
"""
from __future__ import annotations

import errno
import io
import json
import os
import select
import socket
import stat
import struct
import threading
import time
import zlib
from enum import IntEnum
from typing import Any, Optional

import numpy as np

from repro_torch.core.ascent import Compressor
from repro_torch.utils import buckets

Pytree = Any

MAGIC = b"ASAM"
PROTOCOL_VERSION = 1
#: application-level protocol revision, negotiated in HELLO/HELLO_ACK (the
#: frame-header version stays at PROTOCOL_VERSION so v1 peers still parse
#: the handshake); revision 2 adds JOB_DELTA/RESYNC and the job encodings,
#: revision 3 adds the multi-client pool semantics: HELLO identity/auth
#: fields (client_id/group/generation/token), BUSY/DETACH frames, and the
#: pool-telemetry GRAD prelude extension (depth + queue-wait, emitted only
#: when BOTH ends negotiated revision >= 3); revision 4 adds the STATS
#: request/reply frame — a fleet observer scrapes the pool's scheduler
#: counters, per-client wait, and shadow generations over the same socket,
#: no stdout parsing
PROTO_REVISION = 4
#: the protocol revision that introduced the pool semantics above — feature
#: gates must compare against the feature's revision, never PROTO_REVISION
#: (which keeps moving), or a newer client mis-decodes against older servers
POOL_REVISION = 3
STATS_REVISION = 4
#: JOB-direction encodings a revision-2+ server accepts
JOB_ENCODINGS = ("none", "int8", "topk")
FRAME_HEADER_BYTES = 16
#: fixed GRAD-payload prelude: gen u32 + job_step u32 + norm f64 +
#: compute_time f64 + kind u8 + n_leaves u32
GRAD_FIXED_BYTES = 4 + 4 + 8 + 8 + 1 + 4
#: revision-3 pool-telemetry GRAD prelude extension: queue depth u32 +
#: queue-wait seconds f64 (present iff both peers negotiated proto >= 3)
GRAD_POOL_BYTES = 4 + 8
#: fixed JOB_DELTA-payload prelude: sync u32 + seq u32 + gen u32 + step u32 +
#: kind u8 + n_buckets u32
JOB_FIXED_BYTES = 4 + 4 + 4 + 4 + 1 + 4
_MAX_PAYLOAD = 1 << 31   # sanity bound against corrupt length fields

_KIND_CODES = {"none": 0, "int8": 1, "topk": 2}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}

#: JOB_DELTA params-direction kinds ("snapshot" installs/refreshes the shadow)
_JOB_KIND_CODES = {"snapshot": 0, "int8": 1, "topk": 2}
_JOB_KIND_NAMES = {v: k for k, v in _JOB_KIND_CODES.items()}


class FrameType(IntEnum):
    HELLO = 1
    HELLO_ACK = 2
    JOB = 3
    GRAD = 4
    ERROR = 5
    JOB_DELTA = 6
    RESYNC = 7
    #: revision 3 — pool queue full: the job was NOT admitted; the client
    #: should treat the exchange as failed (ledger fallback) and keep its
    #: delta stream as-is (the server applied any shadow delta before
    #: rejecting, so (sync, seq) stays aligned)
    BUSY = 8
    #: revision 3 — the canonical shadow's epoch moved past this client's
    #: delta stream (another client or a reconnect advanced it); payload is
    #: the resync codec carrying the canonical sync the client must
    #: fast-forward beyond before its next snapshot
    DETACH = 9
    #: revision 4 — pool statistics scrape. Request: empty payload
    #: (client -> server, in place of a JOB). Reply: the fixed-layout
    #: binary snapshot `encode_stats` renders (server -> client), exactly
    #: modeled by `stats_frame_bytes` like the JOB/GRAD frames.
    STATS = 10


class ProtocolError(RuntimeError):
    """Malformed frame: bad magic/version/length/checksum/encoding."""


# ---------------------------------------------------------------------------
# Frame layer
# ---------------------------------------------------------------------------

def encode_frame(ftype: FrameType, payload: bytes) -> bytes:
    if len(payload) >= _MAX_PAYLOAD:
        raise ProtocolError(
            f"payload of {len(payload)} bytes exceeds the frame bound "
            f"({_MAX_PAYLOAD}); ship a compressed/sharded representation")
    header = MAGIC + struct.pack(">BBHII", PROTOCOL_VERSION, int(ftype), 0,
                                 len(payload), zlib.crc32(payload))
    return header + payload


def decode_frame_header(header: bytes) -> tuple[FrameType, int, int]:
    """-> (frame type, payload length, expected crc32). Raises ProtocolError."""
    if len(header) != FRAME_HEADER_BYTES or header[:4] != MAGIC:
        raise ProtocolError(f"bad frame magic {header[:4]!r}")
    version, ftype, _flags, length, crc = struct.unpack(">BBHII", header[4:])
    if version != PROTOCOL_VERSION:
        raise ProtocolError(f"protocol version {version} != {PROTOCOL_VERSION}")
    if length > _MAX_PAYLOAD:
        raise ProtocolError(f"payload length {length} exceeds bound")
    try:
        ftype = FrameType(ftype)
    except ValueError:
        raise ProtocolError(f"unknown frame type {ftype}") from None
    return ftype, length, crc


def decode_frame(buf: bytes) -> tuple[FrameType, bytes]:
    """Decode one complete frame from `buf` (exact length)."""
    ftype, length, crc = decode_frame_header(buf[:FRAME_HEADER_BYTES])
    payload = buf[FRAME_HEADER_BYTES:]
    if len(payload) != length:
        raise ProtocolError(f"payload length {len(payload)} != header {length}")
    if zlib.crc32(payload) != crc:
        raise ProtocolError("payload checksum mismatch")
    return ftype, payload


# ---------------------------------------------------------------------------
# Socket helpers (stop-aware blocking I/O)
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, ftype: FrameType, payload: bytes) -> int:
    """Send one frame; returns total bytes on the wire.

    Sends in blocking mode: `recv_exact` leaves a short poll timeout on the
    socket, and since py3.5 that timeout is sendall's budget for the WHOLE
    frame — a multi-MB params frame over a real link needs longer. A send
    wedged on a dead peer is interrupted by close() on the other thread
    (sendall then raises OSError -> the caller's reconnect path).
    """
    frame = encode_frame(ftype, payload)
    sock.settimeout(None)
    sock.sendall(frame)
    return len(frame)


def send_frame_deadline(sock: socket.socket, ftype: FrameType, payload: bytes,
                        timeout: Optional[float]) -> int:
    """`send_frame` with a whole-frame send budget (pool per-client deadline).

    A pool worker sending to a wedged client must not stall its slot forever;
    `timeout` bounds the sendall for the entire frame (None keeps the
    unbounded `send_frame` behavior).
    """
    if timeout is None:
        return send_frame(sock, ftype, payload)
    frame = encode_frame(ftype, payload)
    sock.settimeout(timeout)
    try:
        sock.sendall(frame)
    except socket.timeout as exc:
        raise TimeoutError(f"timed out sending {ftype.name} frame "
                           f"({len(frame)} bytes)") from exc
    return len(frame)


def recv_exact(sock: socket.socket, n: int, *,
               stop: Optional[threading.Event] = None,
               deadline: Optional[float] = None) -> bytes:
    """Read exactly n bytes; poll in short slices so `stop` can interrupt.

    Raises ConnectionError on EOF, TimeoutError past `deadline` (absolute
    time.monotonic()), and ConnectionAbortedError when `stop` is set.

    The poll waits on `select`, not on the socket's timeout: the reference
    sets `sock.settimeout(0.2)` here, and a pool's worker thread sends on the
    same socket with `send_frame_deadline`, whose `sendall` takes the timeout
    the socket has when it starts. When the reader's 0.2 s lands between the
    worker's `settimeout` and `sendall`, a frame that takes longer to send
    (a full-width GRAD of 2 GB) times out and the pool drops the client.
    """
    buf = io.BytesIO()
    got = 0
    while got < n:
        if stop is not None and stop.is_set():
            raise ConnectionAbortedError("stopped while receiving")
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(f"timed out receiving frame ({got}/{n} bytes)")
        try:
            ready, _, _ = select.select([sock], [], [], 0.2)
        except ValueError:          # closed by another thread: fileno() is -1
            raise OSError(errno.EBADF, "socket closed while receiving") from None
        if not ready:
            continue
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            raise ConnectionError("peer closed the connection")
        buf.write(chunk)
        got += len(chunk)
    return buf.getvalue()


def recv_frame(sock: socket.socket, *,
               stop: Optional[threading.Event] = None,
               timeout: Optional[float] = None
               ) -> tuple[FrameType, bytes, int]:
    """Receive one frame -> (type, payload, total wire bytes)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    header = recv_exact(sock, FRAME_HEADER_BYTES, stop=stop, deadline=deadline)
    ftype, length, crc = decode_frame_header(header)
    payload = recv_exact(sock, length, stop=stop, deadline=deadline)
    if zlib.crc32(payload) != crc:
        raise ProtocolError("payload checksum mismatch")
    return ftype, payload, FRAME_HEADER_BYTES + length


# ---------------------------------------------------------------------------
# Address plumbing ("host:port" TCP or "unix:/path" domain sockets)
# ---------------------------------------------------------------------------

def parse_addr(spec: str) -> tuple[str, Any]:
    """-> ("unix", path) | ("tcp", (host, port))."""
    if spec.startswith("unix:"):
        return "unix", spec[len("unix:"):]
    host, _, port = spec.rpartition(":")
    if not host:
        raise ValueError(f"address {spec!r} is not 'host:port' or 'unix:/path'")
    return "tcp", (host, int(port))


def bind_listener(spec: str, backlog: int = 1) -> tuple[socket.socket, str]:
    """Bind + listen on `spec`; returns (socket, resolved address string).

    TCP port 0 resolves to the kernel-assigned port, so callers can always
    advertise a connectable address.
    """
    family, target = parse_addr(spec)
    if family == "unix":
        try:
            if stat.S_ISSOCK(os.stat(target).st_mode):
                os.unlink(target)   # stale path from a previous server:
        except FileNotFoundError:   # bind would fail with EADDRINUSE
            pass
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(target)
        sock.listen(backlog)
        return sock, f"unix:{target}"
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(target)
    sock.listen(backlog)
    host, port = sock.getsockname()[:2]
    return sock, f"{host}:{port}"


def connect(spec: str, timeout: float = 5.0) -> socket.socket:
    family, target = parse_addr(spec)
    if family == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(target)
        return sock
    return socket.create_connection(target, timeout=timeout)


# ---------------------------------------------------------------------------
# Pytree codec (JOB / HELLO payloads): JSON tree spec + raw leaf bytes
# ---------------------------------------------------------------------------

def _np_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes  # registered extension dtypes (bfloat16, ...)
        return np.dtype(getattr(ml_dtypes, name))


def _pack_tree(tree: Pytree, leaves: list) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"t": "dict", "k": list(tree),
                "v": [_pack_tree(tree[k], leaves) for k in tree]}
    if isinstance(tree, (list, tuple)):
        return {"t": "tuple" if isinstance(tree, tuple) else "list",
                "v": [_pack_tree(x, leaves) for x in tree]}
    arr = np.ascontiguousarray(np.asarray(tree))
    leaves.append(arr)
    return {"t": "leaf", "dtype": arr.dtype.name, "shape": list(arr.shape)}


def _unpack_tree(spec: Any, leaves: "list[np.ndarray]", cursor: list) -> Pytree:
    if spec is None:
        return None
    t = spec["t"]
    if t == "dict":
        return {k: _unpack_tree(v, leaves, cursor)
                for k, v in zip(spec["k"], spec["v"])}
    if t in ("list", "tuple"):
        out = [_unpack_tree(v, leaves, cursor) for v in spec["v"]]
        return tuple(out) if t == "tuple" else out
    arr = leaves[cursor[0]]
    cursor[0] += 1
    return arr


def _trees_header(meta: dict, specs: dict) -> bytes:
    return json.dumps({"meta": meta, "trees": specs},
                      separators=(",", ":")).encode()


def encode_trees(meta: dict, **trees: Pytree) -> bytes:
    """Pack host pytrees + JSON-able metadata into one payload.

    Layout: u32 json_len | json {meta, specs} | concatenated leaf bytes.
    """
    leaves: list[np.ndarray] = []
    specs = {name: _pack_tree(tree, leaves) for name, tree in trees.items()}
    header = _trees_header(meta, specs)
    out = io.BytesIO()
    out.write(struct.pack(">I", len(header)))
    out.write(header)
    for arr in leaves:
        out.write(arr.tobytes())
    return out.getvalue()


def _spec_tree(tree: Pytree, nbytes: list) -> Any:
    """`_pack_tree`'s spec for the byte model: same JSON, no serialization.

    Works on anything with .shape and a numpy .dtype (numpy arrays, or
    `np.lib.stride_tricks.as_strided`-style stand-ins) so wire budgets can be
    modeled without materializing the params.
    """
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"t": "dict", "k": list(tree),
                "v": [_spec_tree(tree[k], nbytes) for k in tree]}
    if isinstance(tree, (list, tuple)):
        return {"t": "tuple" if isinstance(tree, tuple) else "list",
                "v": [_spec_tree(x, nbytes) for x in tree]}
    if not hasattr(tree, "shape"):
        tree = np.asarray(tree)
    dtype = np.dtype(tree.dtype)
    n = int(np.prod(tree.shape, dtype=np.int64)) if len(tree.shape) else 1
    nbytes.append(n * dtype.itemsize)
    return {"t": "leaf", "dtype": dtype.name, "shape": list(tree.shape)}


def trees_payload_bytes(meta: dict, **trees: Pytree) -> int:
    """Exact `len(encode_trees(meta, **trees))` without serializing.

    Exact only when `meta`'s JSON rendering is value-independent (the v2 JOB
    path keeps all varying integers in the fixed binary prelude for this
    reason); leaf shapes/dtypes may come from abstract arrays.
    """
    nbytes: list[int] = []
    specs = {name: _spec_tree(tree, nbytes) for name, tree in trees.items()}
    return 4 + len(_trees_header(meta, specs)) + sum(nbytes)


def decode_trees(payload: bytes) -> tuple[dict, dict]:
    """Inverse of encode_trees -> (meta, {name: pytree of np arrays})."""
    (json_len,) = struct.unpack_from(">I", payload, 0)
    header = json.loads(payload[4:4 + json_len].decode())
    off = 4 + json_len
    leaves: list[np.ndarray] = []

    def walk(spec):
        nonlocal off
        if spec is None:
            return
        if spec["t"] == "leaf":
            dtype = _np_dtype(spec["dtype"])
            n = int(np.prod(spec["shape"], dtype=np.int64)) if spec["shape"] else 1
            nbytes = n * dtype.itemsize
            if off + nbytes > len(payload):
                raise ProtocolError("leaf data overruns payload")
            arr = np.frombuffer(payload, dtype=dtype, count=n, offset=off)
            leaves.append(arr.reshape(spec["shape"]))
            off += nbytes
            return
        for v in spec["v"]:
            walk(v)

    for spec in header["trees"].values():
        walk(spec)
    cursor = [0]
    trees = {name: _unpack_tree(spec, leaves, cursor)
             for name, spec in header["trees"].items()}
    return header["meta"], trees


# ---------------------------------------------------------------------------
# JOB / HELLO payloads
# ---------------------------------------------------------------------------

def encode_hello(compressor: Compressor, *,
                 proto: Optional[int] = PROTO_REVISION,
                 job_encodings: Optional[tuple] = JOB_ENCODINGS,
                 client_id: str = "", group: str = "", generation: int = 0,
                 token: str = "", extra: Optional[dict] = None) -> bytes:
    """HELLO / HELLO_ACK payload.

    `version` stays the v1 key a revision-1 peer validates; `proto` and
    `job_encodings` are capability keys it ignores. `proto=None` renders the
    exact revision-1 payload (the degrade test's "old server" mode).

    Revision-3 identity/auth keys are added only when truthy, so a pool-aware
    client talking to a v2 server sends byte-compatible payloads when it has
    nothing to declare: `client_id` (stable identity across reconnects),
    `group` (ascent-sync group — same-group clients receive the group's
    shared smoothed gradient), `generation` (the model generation the client
    attaches its canonical shadow to), `token` (shared-secret auth for
    non-loopback listeners). `extra` merges server-side ACK info (pool
    capability report) without widening this signature per key.
    """
    meta = {"version": PROTOCOL_VERSION, "kind": compressor.kind,
            "topk_fraction": compressor.topk_fraction}
    if proto is not None:
        meta["proto"] = int(proto)
        meta["job_encodings"] = list(job_encodings or ())
    if client_id:
        meta["client_id"] = str(client_id)
    if group:
        meta["group"] = str(group)
    if generation:
        meta["generation"] = int(generation)
    if token:
        meta["token"] = str(token)
    if extra:
        meta.update(extra)
    return json.dumps(meta).encode()


def decode_hello(payload: bytes) -> tuple[Compressor, dict]:
    """-> (gradient-direction Compressor, full handshake meta).

    `meta.get("proto")` is None for a revision-1 peer — the signal to stay on
    full-snapshot v1 JOB frames.
    """
    meta = json.loads(payload.decode())
    if meta.get("version") != PROTOCOL_VERSION:
        raise ProtocolError(f"client protocol version {meta.get('version')} "
                            f"!= {PROTOCOL_VERSION}")
    return Compressor(kind=meta["kind"],
                      topk_fraction=meta["topk_fraction"]), meta


def encode_job(gen: int, step: int, params: Pytree, batch: Pytree,
               rng) -> bytes:
    """Legacy (revision-1) JOB payload: full snapshot, JSON meta."""
    return encode_trees({"gen": int(gen), "step": int(step)},
                        params=params, batch=batch, rng=rng)


def decode_job(payload: bytes) -> tuple[int, int, Pytree, Pytree, Any]:
    meta, trees = decode_trees(payload)
    return (int(meta["gen"]), int(meta["step"]),
            trees["params"], trees["batch"], trees["rng"])


# ---------------------------------------------------------------------------
# JOB_DELTA payload (v2 jobs): fixed prelude + aux trees + bucket sections
#
#   sync u32 | seq u32 | gen u32 | step u32 | kind u8 | n_buckets u32
#   aux_len u32 | encode_trees({}, [params,] batch, rng)
#   per bucket:  int8: size u32 | scale f32 | int8[size]
#                topk: size u32 | k u32 | u32 idx[k] | f32 val[k]
#
# kind "snapshot" ships the full params tree inside the aux (self-describing
# — it is what defines the bucket layout on both ends) with n_buckets == 0;
# sync == 0 marks a *stateless* snapshot (no delta stream will follow, the
# server need not keep a shadow). All varying integers live in the fixed
# prelude so `job_frame_bytes` is exact.
# ---------------------------------------------------------------------------

def encode_job_v2(sync: int, seq: int, gen: int, step: int, batch: Pytree,
                  rng, *, params: Pytree = None, kind: str = "snapshot",
                  deltas: Optional[list] = None) -> bytes:
    """v2 job payload. `deltas` per bucket: (scale, q int8) for "int8",
    (idx u32, val f32) for "topk"; `params` only for kind "snapshot"."""
    deltas = deltas or []
    if kind == "snapshot":
        aux = encode_trees({}, params=params, batch=batch, rng=rng)
    else:
        aux = encode_trees({}, batch=batch, rng=rng)
    out = io.BytesIO()
    out.write(struct.pack(">IIIIBI", int(sync), int(seq), int(gen), int(step),
                          _JOB_KIND_CODES[kind], len(deltas)))
    out.write(struct.pack(">I", len(aux)))
    out.write(aux)
    for entry in deltas:
        if kind == "int8":
            scale, q = entry
            q = np.ascontiguousarray(np.asarray(q, dtype=np.int8))
            out.write(struct.pack(">If", q.size, float(scale)))
            out.write(q.tobytes())
        elif kind == "topk":
            size, idx, val = entry
            idx = np.ascontiguousarray(np.asarray(idx, dtype=np.uint32))
            val = np.ascontiguousarray(np.asarray(val, dtype=np.float32))
            out.write(struct.pack(">II", int(size), idx.size))
            out.write(idx.tobytes())
            out.write(val.tobytes())
        else:
            raise ValueError(f"kind {kind!r} carries no bucket sections")
    return out.getvalue()


def decode_job_v2(payload: bytes):
    """-> (sync, seq, gen, step, kind, params-or-None, batch, rng, buckets).

    `buckets` mirrors encode_job_v2's `deltas`. Raises ProtocolError on any
    structural damage, before the caller touches its shadow.
    """
    if len(payload) < JOB_FIXED_BYTES + 4:
        raise ProtocolError("JOB_DELTA payload shorter than its prelude")
    sync, seq, gen, step, kind_code, n_buckets = struct.unpack_from(
        ">IIIIBI", payload, 0)
    kind = _JOB_KIND_NAMES.get(kind_code)
    if kind is None:
        raise ProtocolError(f"unknown job kind code {kind_code}")
    (aux_len,) = struct.unpack_from(">I", payload, JOB_FIXED_BYTES)
    off = JOB_FIXED_BYTES + 4
    if off + aux_len > len(payload):
        raise ProtocolError("JOB_DELTA aux overruns payload")
    meta, trees = decode_trees(payload[off:off + aux_len])
    off += aux_len
    buckets = []
    for _ in range(n_buckets):
        if kind == "int8":
            if off + 8 > len(payload):
                raise ProtocolError("JOB_DELTA bucket header overruns payload")
            size, scale = struct.unpack_from(">If", payload, off)
            off += 8
            if off + size > len(payload):
                raise ProtocolError("JOB_DELTA int8 bucket overruns payload")
            q = np.frombuffer(payload, np.int8, size, off)
            off += size
            buckets.append((float(scale), q))
        elif kind == "topk":
            if off + 8 > len(payload):
                raise ProtocolError("JOB_DELTA bucket header overruns payload")
            size, k = struct.unpack_from(">II", payload, off)
            off += 8
            if off + 8 * k > len(payload):
                raise ProtocolError("JOB_DELTA topk bucket overruns payload")
            idx = np.frombuffer(payload, np.uint32, k, off)
            off += 4 * k
            val = np.frombuffer(payload, np.float32, k, off)
            off += 4 * k
            buckets.append((int(size), idx, val))
        else:
            raise ProtocolError("snapshot job carries bucket sections")
    if off != len(payload):
        raise ProtocolError(
            f"JOB_DELTA payload has {len(payload) - off} trailing bytes")
    return (int(sync), int(seq), int(gen), int(step), kind,
            trees.get("params"), trees["batch"], trees["rng"], buckets)


def encode_resync(reason: str, sync: int = 0) -> bytes:
    return json.dumps({"reason": reason, "sync": int(sync)}).encode()


def decode_resync(payload: bytes) -> dict:
    try:
        return json.loads(payload.decode())
    except Exception:  # diagnostics only — never fail the resync itself
        return {"reason": payload.decode(errors="replace"), "sync": 0}


def encode_busy(depth: int, gen: int = 0, step: int = 0) -> bytes:
    """BUSY payload: the pool queue depth that rejected this exchange, plus
    the (gen, step) of the rejected job so the client can fail the right
    pending exchange."""
    return json.dumps({"depth": int(depth), "gen": int(gen),
                       "step": int(step)}).encode()


def decode_busy(payload: bytes) -> dict:
    try:
        return json.loads(payload.decode())
    except Exception:  # diagnostics only
        return {"depth": 0, "gen": 0, "step": 0}


# ---------------------------------------------------------------------------
# GRAD payload: fixed binary layout, exact length model
# ---------------------------------------------------------------------------

def _leaf_topk_k(n: int, fraction: float) -> int:
    return max(1, int(n * fraction))


def encode_grad(gen: int, job_step: int, norm: float, compute_time_s: float,
                leaves: "list[np.ndarray]", compressor: Compressor, *,
                pool: Optional[tuple] = None) -> bytes:
    """Pack the ascent gradient leaves (flatten order) for the wire.

    `leaves` is the flatten-order leaf list (`utils.buckets.host_flatten`)
    of the (already error-feedback-compressed, reconstructed) gradient; the
    receiver re-assembles with its own treedef (both ends hold the same
    params structure).

    `pool=(depth, wait_s)` appends the revision-3 pool-telemetry prelude
    extension (GRAD_POOL_BYTES) — only emit it to a peer whose HELLO declared
    proto >= 3, and decode with `decode_grad(..., pool=True)`; a v2 peer
    parsing the extended payload would see trailing bytes.
    """
    kind = compressor.kind
    out = io.BytesIO()
    out.write(struct.pack(">IIddBI", int(gen), int(job_step), float(norm),
                          float(compute_time_s), _KIND_CODES[kind],
                          len(leaves)))
    if pool is not None:
        depth, wait_s = pool
        out.write(struct.pack(">Id", int(depth), float(wait_s)))
    for leaf in leaves:
        arr = np.ascontiguousarray(np.asarray(leaf, dtype=np.float32))
        out.write(struct.pack(">B", arr.ndim))
        out.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        if kind == "none":
            out.write(struct.pack(">B", 0))    # dtype code: fp32
            out.write(arr.tobytes())
        elif kind == "int8":
            amax = float(np.max(np.abs(arr))) if arr.size else 0.0
            scale = (amax / 127.0) or 1.0
            q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
            out.write(struct.pack(">d", scale))
            out.write(q.tobytes())
        elif kind == "topk":
            flat = arr.reshape(-1)
            k = _leaf_topk_k(flat.size, compressor.topk_fraction)
            idx = np.argpartition(np.abs(flat), -k)[-k:].astype(np.uint32)
            out.write(struct.pack(">I", k))
            out.write(idx.tobytes())
            out.write(flat[idx].astype(np.float32).tobytes())
        else:
            raise ValueError(f"unknown compressor kind {kind!r}")
    return out.getvalue()


def decode_grad(payload: bytes, *, pool: bool = False
                ) -> tuple[int, int, float, float, "list[np.ndarray]", dict]:
    """-> (gen, job_step, norm, compute_time_s, fp32 leaves, pool_meta).

    `pool=True` parses the revision-3 pool-telemetry prelude extension into
    `pool_meta` ({"pool_depth", "pool_wait_s"}); with `pool=False` (a v2
    GRAD) `pool_meta` is empty. The flag is the HELLO/HELLO_ACK-negotiated
    capability — payloads are not self-describing here so the exact byte
    model stays exact.
    """
    gen, job_step, norm, dt, kind_code, n_leaves = struct.unpack_from(
        ">IIddBI", payload, 0)
    kind = _KIND_NAMES.get(kind_code)
    if kind is None:
        raise ProtocolError(f"unknown grad kind code {kind_code}")
    off = GRAD_FIXED_BYTES
    pool_meta: dict = {}
    if pool:
        depth, wait_s = struct.unpack_from(">Id", payload, off)
        off += GRAD_POOL_BYTES
        pool_meta = {"pool_depth": int(depth), "pool_wait_s": float(wait_s)}
    leaves = []
    for _ in range(n_leaves):
        (ndim,) = struct.unpack_from(">B", payload, off)
        off += 1
        shape = struct.unpack_from(f">{ndim}I", payload, off)
        off += 4 * ndim
        n = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        if kind == "none":
            off += 1                            # dtype code (fp32 only)
            arr = np.frombuffer(payload, np.float32, n, off).reshape(shape)
            off += 4 * n
        elif kind == "int8":
            (scale,) = struct.unpack_from(">d", payload, off)
            off += 8
            q = np.frombuffer(payload, np.int8, n, off).reshape(shape)
            off += n
            arr = q.astype(np.float32) * np.float32(scale)
        else:                                   # topk
            (k,) = struct.unpack_from(">I", payload, off)
            off += 4
            idx = np.frombuffer(payload, np.uint32, k, off)
            off += 4 * k
            val = np.frombuffer(payload, np.float32, k, off)
            off += 4 * k
            flat = np.zeros(n, np.float32)
            flat[idx] = val
            arr = flat.reshape(shape)
        leaves.append(np.ascontiguousarray(arr))
    if off != len(payload):
        raise ProtocolError(f"grad payload has {len(payload) - off} trailing bytes")
    return int(gen), int(job_step), float(norm), float(dt), leaves, pool_meta


def grad_frame_bytes(compressor: Compressor, grad: Pytree, *,
                     pool: bool = False) -> int:
    """Exact length of the GRAD *frame* that would carry `grad`.

    `Compressor.wire_bytes` models the compressed payload only; this adds the
    framing the payload model deliberately excludes: the 16-byte frame header,
    the fixed GRAD prelude (plus the revision-3 pool-telemetry extension when
    `pool=True` — a proto>=3 pair always carries it), and the per-leaf
    shape/structure metadata. A test asserts modeled ==
    len(encode_frame(...)) for every compressor kind.
    """
    leaves, _ = buckets.host_flatten(grad)
    structural = sum(1 + 4 * len(leaf.shape) for leaf in leaves)   # ndim + dims
    if compressor.kind == "none":
        structural += len(leaves)        # dtype code byte
    elif compressor.kind == "topk":
        structural += 4 * len(leaves)    # per-leaf k
    # int8's per-leaf 8-byte scale is already part of the payload model
    return (FRAME_HEADER_BYTES + GRAD_FIXED_BYTES
            + (GRAD_POOL_BYTES if pool else 0) + structural
            + compressor.wire_bytes(grad))


# ---------------------------------------------------------------------------
# JOB frame: exact length model (v2 jobs), layered like grad_frame_bytes
# ---------------------------------------------------------------------------

def _bucket_sizes(params: Pytree) -> list[int]:
    """Element count per dtype bucket, via the canonical layout grouping."""
    return [g.size for g in buckets.host_layout(params).groups]


def job_frame_breakdown(encoding: str, params: Pytree, batch: Pytree, rng, *,
                        delta: bool = True,
                        topk_fraction: float = 0.01) -> dict:
    """Exact v2 JOB *frame* length model, split by wire direction content.

    Returns {"frame": total frame bytes, "aux": the params-free cost every
    job form pays (frame header, fixed prelude, batch + rng payload and
    their tree-spec JSON), "params": frame - aux, i.e. every byte the params
    direction adds — raw fp32 leaves plus their tree-spec JSON for a
    snapshot, the delta bucket sections for int8/topk}. `params`/`batch`/
    `rng` may be abstract (ShapeDtypeStructs) — wire budgets for pod-scale
    models are modeled without materializing them. Exact because every
    run-varying integer (sync/seq/gen/step) lives in the fixed-width binary
    prelude; a test asserts modeled == len(encode_frame(...)) per encoding.
    """
    common = (FRAME_HEADER_BYTES + JOB_FIXED_BYTES + 4
              + trees_payload_bytes({}, batch=batch, rng=rng))
    snapshot = (encoding == "none") or not delta
    if snapshot:
        frame = (FRAME_HEADER_BYTES + JOB_FIXED_BYTES + 4
                 + trees_payload_bytes({}, params=params, batch=batch,
                                       rng=rng))
        return {"frame": frame, "params": frame - common, "aux": common}
    sizes = _bucket_sizes(params)
    if encoding == "int8":
        section = sum(8 + n for n in sizes)
    elif encoding == "topk":
        section = sum(8 + 8 * max(1, int(n * topk_fraction)) for n in sizes)
    else:
        raise ValueError(f"unknown job encoding {encoding!r}")
    return {"frame": common + section, "params": section, "aux": common}


def job_frame_bytes(encoding: str, params: Pytree, batch: Pytree, rng, *,
                    delta: bool = True, topk_fraction: float = 0.01) -> int:
    """Exact length of the v2 JOB frame carrying one exchange out.

    `encoding` "none" (or `delta=False`) models the full-snapshot form;
    "int8"/"topk" model the delta-encoded bucket sections. The legacy
    (revision-1) JOB frame is not modeled — its JSON meta length varies with
    gen/step digits; v2 keeps those in the fixed prelude precisely so this
    model can be exact.
    """
    return job_frame_breakdown(encoding, params, batch, rng, delta=delta,
                               topk_fraction=topk_fraction)["frame"]


# ---------------------------------------------------------------------------
# STATS payload (revision 4): fixed binary layout, exact length model
#
#   ver u8 | workers u16 | queue_cap u16 | queue_depth u32
#   17 x u64 scheduler counters (STATS_COUNTER_KEYS order)
#   n_clients u32 | per client:  uid u32 | group_uid u32 | exchanges u32 |
#                                last_wait_s f64                   (20 bytes)
#   n_shadows u32 | per shadow:  scope_uid u32 | gen u32 | sync u32 |
#                                seq u32 | replays u32              (20 bytes)
#
# Everything run-varying is fixed-width binary, so `stats_frame_bytes` is
# exact the same way grad/job_frame_bytes are; the payload version byte lets
# the layout grow without another protocol revision.
# ---------------------------------------------------------------------------

#: the pool's scheduler counters, in `AscentPool.stats()` order — the wire
#: layout freezes this order, so it is append-only
STATS_COUNTER_KEYS = (
    "connections", "clients", "exchanges", "busy_rejections",
    "auth_rejections", "resyncs_sent", "detaches_sent", "shadow_installs",
    "shadow_skips", "deltas_applied", "delta_replays", "shadows",
    "group_hits", "group_computes", "server_errors", "dropped_clients",
    "orphaned_jobs",
)
STATS_PAYLOAD_VERSION = 1
#: ver + workers + queue_cap + queue_depth + counters + the two list lengths
STATS_FIXED_BYTES = (1 + 2 + 2 + 4) + 8 * len(STATS_COUNTER_KEYS) + 4 + 4
STATS_CLIENT_BYTES = 4 + 4 + 4 + 8
STATS_SHADOW_BYTES = 4 + 4 + 4 + 4 + 4


def encode_stats(snap: dict) -> bytes:
    """Pack a `AscentPool.stats_snapshot()` dict for the wire."""
    out = io.BytesIO()
    out.write(struct.pack(">BHHI", STATS_PAYLOAD_VERSION,
                          int(snap.get("workers", 0)),
                          int(snap.get("queue_capacity", 0)),
                          int(snap.get("queue_depth", 0))))
    for key in STATS_COUNTER_KEYS:
        out.write(struct.pack(">Q", int(snap.get(key, 0))))
    clients = snap.get("clients_detail", [])
    out.write(struct.pack(">I", len(clients)))
    for c in clients:
        out.write(struct.pack(">IIId", int(c["uid"]), int(c["group_uid"]),
                              int(c["exchanges"]), float(c["last_wait_s"])))
    shadows = snap.get("shadows_detail", [])
    out.write(struct.pack(">I", len(shadows)))
    for s in shadows:
        out.write(struct.pack(">IIIII", int(s["scope_uid"]), int(s["gen"]),
                              int(s["sync"]), int(s["seq"]),
                              int(s["replays"])))
    return out.getvalue()


def decode_stats(payload: bytes) -> dict:
    """Inverse of encode_stats -> the snapshot dict shape."""
    if len(payload) < STATS_FIXED_BYTES:
        raise ProtocolError("STATS payload shorter than its fixed layout")
    ver, workers, queue_cap, queue_depth = struct.unpack_from(">BHHI",
                                                              payload, 0)
    if ver != STATS_PAYLOAD_VERSION:
        raise ProtocolError(f"STATS payload version {ver} "
                            f"!= {STATS_PAYLOAD_VERSION}")
    off = 9
    snap: dict = {"workers": int(workers), "queue_capacity": int(queue_cap),
                  "queue_depth": int(queue_depth)}
    for key in STATS_COUNTER_KEYS:
        (snap[key],) = struct.unpack_from(">Q", payload, off)
        snap[key] = int(snap[key])
        off += 8
    (n_clients,) = struct.unpack_from(">I", payload, off)
    off += 4
    clients = []
    for _ in range(n_clients):
        if off + STATS_CLIENT_BYTES > len(payload):
            raise ProtocolError("STATS client entry overruns payload")
        uid, group_uid, exchanges, last_wait = struct.unpack_from(
            ">IIId", payload, off)
        off += STATS_CLIENT_BYTES
        clients.append({"uid": int(uid), "group_uid": int(group_uid),
                        "exchanges": int(exchanges),
                        "last_wait_s": float(last_wait)})
    snap["clients_detail"] = clients
    if off + 4 > len(payload):
        raise ProtocolError("STATS shadow count overruns payload")
    (n_shadows,) = struct.unpack_from(">I", payload, off)
    off += 4
    shadows = []
    for _ in range(n_shadows):
        if off + STATS_SHADOW_BYTES > len(payload):
            raise ProtocolError("STATS shadow entry overruns payload")
        scope_uid, gen, sync, seq, replays = struct.unpack_from(
            ">IIIII", payload, off)
        off += STATS_SHADOW_BYTES
        shadows.append({"scope_uid": int(scope_uid), "gen": int(gen),
                        "sync": int(sync), "seq": int(seq),
                        "replays": int(replays)})
    snap["shadows_detail"] = shadows
    if off != len(payload):
        raise ProtocolError(
            f"STATS payload has {len(payload) - off} trailing bytes")
    return snap


def stats_frame_bytes(n_clients: int, n_shadows: int) -> int:
    """Exact length of the STATS reply frame for a snapshot of this size.

    Layered like `grad_frame_bytes`/`job_frame_bytes`: frame header + fixed
    payload layout + fixed-width per-entry sections, so a test asserts
    modeled == len(encode_frame(...)) against a live scrape.
    """
    return (FRAME_HEADER_BYTES + STATS_FIXED_BYTES
            + STATS_CLIENT_BYTES * n_clients
            + STATS_SHADOW_BYTES * n_shadows)
