"""Delta-encoded JOB payloads: the params direction of the ascent exchange
(counterpart of `repro.service.delta`).

Both ends keep an fp32 *shadow* of the last-synced params, one buffer per
dtype bucket (the reference's grouping: `utils.buckets.host_layout` of the
snapshot's tree on the server, which is the client's device bucket element
for element). Per exchange the client ships `quantize(params - shadow +
residual)` per bucket and BOTH ends advance their shadow by the *quantized*
value, so the server's reconstruction never drifts from the client's; the
quantization error stays client-side as an error-feedback residual folded
into the next delta. Any doubt about the server's shadow (reconnect, RESYNC,
executor reset) falls back to a full-snapshot JOB that re-installs it under a
fresh sync id.

`JobEncoder` (client) keeps the shadow and the residual on the params'
device and encodes with two kernels per bucket, `kernels.ops.delta_amax`
(the scale probe; one host sync for the scale) and `delta_encode_i8` (q into
a fresh int8 buffer, the shadow and residual advanced in place), then copies
q to the host. The power-of-two scale (`_pow2_scale`) makes `q * scale`
exact, so the kernel's shadow advance and the server's numpy
`buf += q.astype(f32) * f32(scale)` round alike. `ShadowState` (server) is
the numpy receiving end.

Where the port departs from the reference: the reference's encoder turns any
exception of the delta encode into a full snapshot plus one stderr line. The
port degrades so only for layout drift (`LayoutDrift`: the params' buckets no
longer match the shadow's); an error of a kernel (its build, load or launch)
propagates, so a failing kernel is never hidden behind fp32 snapshots.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.service import protocol
from repro_torch.service.protocol import ProtocolError
from repro_torch.utils import buckets

Tree = Any


class LayoutDrift(ValueError):
    """The params' buckets no longer match the encoder's shadow."""


@dataclasses.dataclass
class EncodedJob:
    """One encoded exchange-out, ready for the client worker to frame.

    `params` (host tree) is present only for kind "snapshot"; `deltas` holds
    the per-bucket sections (`protocol.encode_job_v2` format) otherwise.
    `treedef` is the params tree structure the GRAD reply unflattens into.
    """
    kind: str
    sync: int
    seq: int
    gen: int
    step: int
    batch: Tree
    rng: Any
    treedef: Any
    params: Tree = None
    deltas: Optional[list] = None


def _caps_default() -> tuple[Optional[bool], set]:
    return None, set()


def _pow2_scale(amax: float) -> np.float32:
    """Smallest power of two >= amax/127 (1.0 for a zero, inf or NaN delta).

    A power-of-two scale makes `q * scale` exact in fp32, so the shadow
    advance `s + q * scale` rounds the same in the kernel, the plain version
    and the server's numpy apply. It costs at most 2x quantization
    granularity, absorbed by error feedback.
    """
    raw = amax / 127.0
    if not (raw > 0.0) or not math.isfinite(raw):
        return np.float32(1.0)
    return np.float32(2.0 ** math.ceil(math.log2(raw)))


def _param_buckets(params, layout: buckets.HostLayout) -> list[torch.Tensor]:
    """The params as flat buffers in `layout`'s group order: a BucketedState's
    own buffers, a mapping of name -> tensor gathered, a host tree
    concatenated on the host."""
    if buckets.is_bucketed(params):
        return list(params.buffers)
    if isinstance(params, dict) and all(isinstance(v, torch.Tensor) for v in params.values()):
        return list(buckets.BucketedState.from_tree(params).buffers)
    return [torch.from_numpy(b.copy()) for b in buckets.host_tree_to_buckets(params, layout)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class JobEncoder:
    """Client-side JOB encoding with shadow + error-feedback state.

    `caps_fn` reports the negotiated server capabilities `(v2_ok:
    True/False/None-unknown, supported encodings)`; the encoder degrades to
    full snapshots whenever delta encoding is not (yet) known to be safe.
    Thread-safe: `encode` runs on the executor thread at submit time (before
    the next descent writes the params in place), `invalidate` / `resync_job`
    on the client worker thread.
    """

    def __init__(self, encoding: str = "none", *, topk_fraction: float = 0.01,
                 delta: bool = True, caps_fn: Callable[[], tuple] = _caps_default,
                 impl: Optional[str] = None):
        if encoding not in protocol.JOB_ENCODINGS:
            raise ValueError(f"unknown job encoding {encoding!r}")
        self.encoding = encoding
        self.topk_fraction = topk_fraction
        self.delta = delta
        self._caps_fn = caps_fn
        self._impl = impl
        self._lock = threading.Lock()
        self._shadow: Optional[list] = None   # fp32 buffers on the params' device
        self._err: Optional[list] = None      # fp32 residual, congruent
        self._layout: Optional[buckets.HostLayout] = None
        self._leaf_dtypes: Optional[list] = None
        self._sync = 0          # monotonically increasing install id
        self._seq = 0           # delta counter within the current sync
        self._sync_floor = 0    # DETACH fast-forward floor for the next install
        # telemetry
        self.snapshot_jobs = 0
        self.delta_jobs = 0
        self.resyncs = 0
        self.encode_failures = 0
        self.last_encode_error = ""
        self.last_d2h_s = 0.0   # the delta sections' copy to the host, last job

    # --- state management ------------------------------------------------------
    def invalidate(self) -> None:
        """Drop the shadow: the next job is a full snapshot under a new sync
        id (connection drops, RESYNC, executor reset)."""
        with self._lock:
            self._shadow = self._err = None
            self._layout = self._leaf_dtypes = None

    def fast_forward(self, sync: int) -> None:
        """Raise the floor for the next install id past the pool's canonical
        shadow sync (a DETACH); `_sync`/`_seq` stay, so an in-flight job can
        still be rebuilt by `resync_job`."""
        with self._lock:
            self._sync_floor = max(self._sync_floor, int(sync))

    def _wants_delta(self) -> bool:
        if not self.delta or self.encoding == "none":
            return False
        v2, encodings = self._caps_fn()
        if v2 is False:
            return False          # revision-1 server: snapshots only
        return v2 is None or self.encoding in encodings

    # --- encoding --------------------------------------------------------------
    def encode(self, gen: int, params, batch: Tree, rng, step: int) -> EncodedJob:
        """Encode one job against the current shadow (delta when possible).

        `params` may be a `BucketedState`, a mapping of name -> tensor, or a
        host tree (the calibration probe path); `batch`/`rng` are host values.
        """
        with self._lock:
            if self._wants_delta() and self._shadow is not None:
                try:
                    return self._encode_delta(gen, params, batch, rng, step)
                except LayoutDrift as e:
                    self._shadow = self._err = None
                    self.encode_failures += 1
                    msg = f"delta encode failed ({type(e).__name__}: {e}); sending full snapshot"
                    if msg != self.last_encode_error:
                        print(f"[job-encoder] {msg}", file=sys.stderr, flush=True)
                    self.last_encode_error = msg
            return self._encode_snapshot(gen, params, batch, rng, step)

    def _encode_snapshot(self, gen, params, batch, rng, step) -> EncodedJob:
        host = buckets.host_portable(params)
        leaves, treedef = buckets.host_flatten(host)
        sync = 0
        if self._wants_delta():
            layout = buckets.host_layout(host)
            self._shadow = [b.to(torch.float32, copy=True)
                            for b in _param_buckets(params, layout)]
            self._err = [torch.zeros_like(s) for s in self._shadow]
            self._layout = layout
            self._leaf_dtypes = [np.asarray(x).dtype for x in leaves]
            self._sync = max(self._sync, self._sync_floor) + 1
            self._seq = 0
            sync = self._sync
        self.snapshot_jobs += 1
        return EncodedJob(kind="snapshot", sync=sync, seq=0, gen=gen, step=step, batch=batch,
                          rng=rng, treedef=treedef, params=host)

    def _encode_delta(self, gen, params, batch, rng, step) -> EncodedJob:
        bufs = _param_buckets(params, self._layout)
        if (len(bufs) != len(self._shadow)
                or any(b.numel() != s.numel() for b, s in zip(bufs, self._shadow))):
            raise LayoutDrift("params layout no longer matches the shadow")
        dev = bufs[0].device
        if self._shadow[0].device != dev:        # the params moved: so does the shadow
            self._shadow = [s.to(dev) for s in self._shadow]
            self._err = [e.to(dev) for e in self._err]
        deltas, d2h_s = [], 0.0
        for p, s, e in zip(bufs, self._shadow, self._err):
            if self.encoding == "int8":
                amax = float(ops.delta_amax(p, s, e, impl=self._impl))
                scale = _pow2_scale(amax)
                q, _, _ = ops.delta_encode_i8(p, s, e, float(scale), impl=self._impl)
                _sync(q.device)
                t0 = time.perf_counter()
                deltas.append((float(scale), q.cpu().numpy()))
                d2h_s += time.perf_counter() - t0
            else:                                   # topk
                d = p.float() - s + e
                k = max(1, int(d.shape[0] * self.topk_fraction))
                _, idx = torch.topk(torch.abs(d), k)
                val = d[idx]
                s[idx] += val
                d[idx] = 0.0
                e.copy_(d)
                deltas.append((int(d.shape[0]), idx.cpu().numpy().astype(np.uint32),
                               val.cpu().numpy()))
        self.last_d2h_s = d2h_s
        self._seq += 1
        self.delta_jobs += 1
        return EncodedJob(kind=self.encoding, sync=self._sync, seq=self._seq, gen=gen,
                          step=step, batch=batch, rng=rng, treedef=self._layout.treedef,
                          deltas=deltas)

    # --- resync ----------------------------------------------------------------
    def resync_job(self, job: EncodedJob) -> Optional[EncodedJob]:
        """Rebuild `job` as a full-snapshot JOB of the *current shadow*: the
        shadow after encoding `job` is exactly what the server would have
        reconstructed from it, so the resent exchange is bitwise the same.
        Returns None when the shadow has advanced past `job`."""
        if job.kind == "snapshot":
            return job               # snapshots are naturally idempotent
        with self._lock:
            if (self._shadow is None or self._layout is None
                    or job.sync != self._sync or job.seq != self._seq):
                return None
            host_bufs = [s.cpu().numpy() for s in self._shadow]
            tree = buckets.host_buckets_to_tree(host_bufs, self._layout, self._leaf_dtypes)
            # a lossy leaf dtype (bf16) rounds the snapshot the server will
            # install: re-derive our shadow through the same cast and fold the
            # rounding into the residual, so both shadows stay bit-identical
            if any(g.dtype != "float32" for g in self._layout.groups):
                cast_bufs = buckets.host_tree_to_buckets(tree, self._layout)
                for gi, grp in enumerate(self._layout.groups):
                    if grp.dtype == "float32":
                        continue
                    s = self._shadow[gi]
                    s_new = torch.from_numpy(cast_bufs[gi].astype(np.float32)).to(s.device)
                    self._err[gi] = self._err[gi] + (s - s_new)
                    self._shadow[gi] = s_new
            self._sync = max(self._sync, self._sync_floor) + 1
            self._seq = 0
            self.resyncs += 1
            self.snapshot_jobs += 1
            return EncodedJob(kind="snapshot", sync=self._sync, seq=0, gen=job.gen,
                              step=job.step, batch=job.batch, rng=job.rng,
                              treedef=job.treedef, params=tree)

    def shadow_host(self) -> Optional[list[np.ndarray]]:
        """Host copies of the shadow buffers (what the server holds)."""
        with self._lock:
            return None if self._shadow is None else [s.cpu().numpy() for s in self._shadow]


# ---------------------------------------------------------------------------
# Server side: the numpy shadow a connection reconstructs params from
# ---------------------------------------------------------------------------

class ShadowState:
    """The receiving end of one delta stream.

    Installed from a snapshot JOB (sync >= 1), advanced by int8/topk bucket
    sections with strict sync/seq checking; any mismatch means the ends have
    skewed and the caller must ask for a RESYNC. Sections are validated
    before any buffer is touched, so a corrupted frame never half-applies.
    """

    def __init__(self):
        self.layout: Optional[buckets.HostLayout] = None
        self.bufs: Optional[list] = None      # fp32 numpy, one per bucket
        self.leaf_dtypes: Optional[list] = None
        self.sync = 0
        self.seq = 0
        self.installs = 0
        self.deltas_applied = 0

    def install(self, params: Tree, sync: int) -> None:
        self.layout = buckets.host_layout(params)
        leaves, _ = buckets.host_flatten(params)
        self.leaf_dtypes = [np.asarray(x).dtype for x in leaves]
        # writable owned buffers: decoded leaves are read-only views of the
        # frame, and a single-leaf bucket would alias them
        self.bufs = [np.array(b, dtype=np.float32, copy=True)
                     for b in buckets.host_tree_to_buckets(params, self.layout)]
        self.sync = int(sync)
        self.seq = 0
        self.installs += 1

    def can_apply(self, sync: int, seq: int) -> bool:
        return self.bufs is not None and int(sync) == self.sync and int(seq) == self.seq + 1

    def apply(self, kind: str, sections: list, sync: int, seq: int) -> None:
        """Advance the shadow by one fully-decoded delta."""
        if not self.can_apply(sync, seq):
            raise ProtocolError(f"delta (sync={sync}, seq={seq}) does not extend shadow "
                                f"(sync={self.sync}, seq={self.seq})")
        if len(sections) != len(self.bufs):
            raise ProtocolError(f"delta has {len(sections)} buckets, shadow has "
                                f"{len(self.bufs)}")
        for i, (entry, buf) in enumerate(zip(sections, self.bufs)):
            if kind == "int8":
                _scale, q = entry
                if q.size != buf.size:
                    raise ProtocolError(f"bucket {i}: int8 payload of {q.size} elements "
                                        f"!= shadow size {buf.size}")
            else:                                   # topk
                size, idx, _val = entry
                if size != buf.size:
                    raise ProtocolError(f"bucket {i}: topk section for {size} elements "
                                        f"!= shadow size {buf.size}")
                if idx.size and int(idx.max()) >= buf.size:
                    raise ProtocolError(f"bucket {i}: topk index out of range")
        for entry, buf in zip(sections, self.bufs):
            if kind == "int8":
                scale, q = entry
                # f32 mul-then-add; the power-of-two scale makes the product
                # exact, matching the encoder kernel's advance bit for bit
                buf += q.astype(np.float32) * np.float32(scale)
            else:                                   # topk
                _size, idx, val = entry
                buf[idx] += val
        self.seq = int(seq)
        self.deltas_applied += 1

    def params(self) -> Tree:
        """The params tree the current shadow encodes (original dtypes)."""
        return buckets.host_buckets_to_tree(self.bufs, self.layout, self.leaf_dtypes)
