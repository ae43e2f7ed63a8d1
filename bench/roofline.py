"""The yardstick of the kernels' roofline shares: the least time one call
could take on one NVIDIA H100 SXM, from the call's shapes and dtypes.

A call's bound is the larger of
* its bytes (each operand read once, each output written once) over the
  HBM bandwidth, and
* the operations the function needs over the tensor-core peak of its input
  dtype: 989 TFLOP/s for bf16 and fp16, 495 TFLOP/s for fp32 (as TF32).
Taking the tensor-core peak for every function, including a recurrence
that an implementation might run on the CUDA cores, means no
implementation can read over 100%.

Each operator's bytes and operations are counted by a module of its own,
`bounds/<operator>.py` (the name after "repro_torch::"), whose
`bound(shapes, dtypes, inputs)` gives (bytes, operations, dtype): a new
kernel's bound is a new file there. The counts they share are here.

Peaks: NVIDIA H100 SXM data sheet, dense, at the card's 700 W limit.
"""
from __future__ import annotations

import importlib
import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
ELEM_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8, "int": 4,
              "long int": 8, "bool": 1, "float32": 4, "bfloat16": 2, "float16": 2}
DTYPE_NAMES = {"float": "float32", "c10::BFloat16": "bfloat16", "c10::Half": "float16"}


def nbytes(shape, dtype: str) -> int:
    """Bytes of a tensor argument (a scalar or an absent tensor: 0)."""
    if not shape or dtype not in ELEM_BYTES:
        return 0
    return math.prod(shape) * ELEM_BYTES[dtype]


def visible_pairs(sq: int, sk: int, causal: bool, window: int = 0, q_offset: int = 0) -> int:
    """(query, key) pairs a causal or windowed mask lets through: query i at
    position q_offset + i sees keys [max(0, p - window + 1), min(sk, p + 1))
    (causal), or all sk."""
    def upto(n: int) -> int:               # sum over j = 1..n of min(sk, j)
        n = max(0, n)
        m = min(n, sk)
        return m * (m + 1) // 2 + (n - m) * sk

    o = q_offset
    seen = upto(o + sq) - upto(o) if causal else sq * sk
    return seen - (upto(o + sq - window) - upto(o - window) if window else 0)


def flash_bound(q, k, v, dtype: str, causal: bool = True, window: int = 0,
                q_offset: int = 0) -> tuple[float, float]:
    """(bytes, operations) of one forward: q (B,Sq,H,hd), k (B,Sk,K,hd), v
    (B,Sk,K,hd_v); k and v read only for the keys some query sees."""
    b, sq, h, hd = q
    sk, kv, hd_v = k[1], k[2], v[3]
    elem = ELEM_BYTES[dtype]
    hi = min(sk, q_offset + sq) if causal else sk
    lo = max(0, q_offset - window + 1) if window else 0
    keys = max(0, hi - lo)
    by = elem * (b * sq * h * hd + b * keys * kv * (hd + hd_v) + b * sq * h * hd_v)
    ops = 2 * (hd + hd_v) * b * h * visible_pairs(sq, sk, causal, window, q_offset)
    return float(by), float(ops)


def epilogue_bytes(shapes, dtypes, out_only=(), written=(), scalars: int = 0) -> float:
    """Bytes of one weight-space kernel call: the tensors it reads (every
    argument but those in `out_only`) read once, the buffers it writes
    (`written`, in place or out) written once, and `scalars` bytes of
    results."""
    read = sum(nbytes(sh, dt) for i, (sh, dt) in enumerate(zip(shapes, dtypes))
               if i not in out_only)
    write = sum(nbytes(shapes[i], dtypes[i]) for i in written if i < len(shapes))
    return float(read + write + scalars)


def call_bound_s(name: str, shapes, dtypes, inputs) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations") of one call of a
    `repro_torch::` operator, from its recorded shapes, dtypes and scalar
    inputs, by its module under `bounds/`."""
    short = name.split("::")[-1]
    try:
        mod = importlib.import_module(f"bench.bounds.{short}")
    except ModuleNotFoundError:
        raise KeyError(f"no bound for {name}: no bench/bounds/{short}.py") from None
    by, ops, dtype = mod.bound(shapes, dtypes, inputs)
    t_bytes, t_ops = by / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(trace, names: tuple[str, ...]) -> tuple[float, dict] | None:
    """(100 x the calls' summed bounds / the device seconds charged to
    them, {"bytes": n, "operations": n} calls by what bound them) over the
    calls of `names` in a trace; None where no device time was charged."""
    device = trace.device_s(names)
    calls = trace.calls(names)
    if device <= 0 or not calls:
        return None
    total, by = 0.0, {"bytes": 0, "operations": 0}
    for op in calls:
        t, kind = call_bound_s(op.name, op.shapes, op.dtypes, op.inputs)
        total += t
        by[kind] += 1
    return 100.0 * total / device, by
