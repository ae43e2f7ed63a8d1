"""repro_torch.service — the multi-host ascent lane (counterpart of
`repro.service`, its wire byte for byte).

The heterogeneous executor's ascent lane, moved out of process: a standalone
`AscentServer` (``python -m repro_torch.service.ascent_server``) holds the
loss function and computes ascent gradients on its device; a non-blocking
`RemoteAscentClient` satisfies the same lane protocol as the in-process
thread lane (`runtime.async_executor.AscentLane`), streaming params/batch
frames out and gradient frames back over TCP or Unix sockets.
`engine.RemoteExecutor` plugs the client into `Engine.fit` unchanged.

`protocol` owns the frame format and the exact wire-byte models in both
directions; `delta` the delta-encoded params direction (client `JobEncoder`
on two kernels, `delta_amax` and `delta_encode_i8`; server `ShadowState`);
`pool` the multi-client serve core (`AscentPool`); `netchaos` the
frame-aware chaos proxy for the wire (`ChaosProxy`).
"""
from repro_torch.service.ascent_server import (  # noqa: F401
    AscentServer,
    ServerHandle,
    resolve_loss,
    spawn_server,
)
from repro_torch.service.client import (  # noqa: F401
    RemoteAscentClient,
    fetch_pool_stats,
)
from repro_torch.service.delta import JobEncoder, ShadowState  # noqa: F401
from repro_torch.service.netchaos import (  # noqa: F401
    ChaosProxy,
    FaultRule,
    FaultSchedule,
    parse_faults,
)
from repro_torch.service.pool import (  # noqa: F401
    AscentPool,
    PoolConfig,
    SharedShadow,
)
from repro_torch.service.protocol import (  # noqa: F401
    FrameType,
    ProtocolError,
    decode_frame,
    decode_stats,
    encode_frame,
    encode_stats,
    grad_frame_bytes,
    job_frame_breakdown,
    job_frame_bytes,
    stats_frame_bytes,
)
