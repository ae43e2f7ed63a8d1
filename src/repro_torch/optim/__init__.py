from repro_torch.optim.base import (  # noqa: F401
    AdamState,
    ClipState,
    FusedSpec,
    GradientTransform,
    ScaleByScheduleState,
    TraceState,
    adamw,
    as_schedule,
    constant_schedule,
    cosine_schedule,
    make_optimizer,
    sgd,
    step_decay_schedule,
)
from repro_torch.optim.fused import epilogue_hbm_bytes, fused_apply  # noqa: F401
