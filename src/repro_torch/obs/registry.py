"""Typed metric-key registry: the one list of step metrics (counterpart of
`repro.obs.registry`, the same keys, fields and order).

Every scalar an executor, lane, pool or callback emits per step is declared
here as a `MetricKey`; the `ENGINE_METRIC_KEYS` / `ENGINE_OPTIONAL_METRIC_KEYS`
tuples of the engine contract are derived from it (`engine.api` re-exports
them). The strict in-memory tracker sink rejects writes of unregistered keys,
and the port's tests scan `src/repro_torch` for metric writes outside this
table.

Key groups (the `source` field):

    core     emitted by the step (method metrics dicts / _finish)
    model    scalar aux terms a model's loss_fn returns (pass through _m)
    engine   derived by the Engine fit loop (step timing)
    lane     the hetero/async executor's staleness contract
    remote   the remote ascent lane's wire accounting, per harvested exchange
    pool     multi-client ascent-pool scheduler pressure
    elastic  mesh capacity + resize costs (the reference's elastic executor)
    guard    the numerics guard's ladder/rollback telemetry (runtime.guard)

Ordering is load-bearing: the `required` keys render in the
`ENGINE_METRIC_KEYS` order and the `optional` keys in the
`ENGINE_OPTIONAL_METRIC_KEYS` order, which is also the field order of
`StalenessTelemetry`'s jsonl records: the jsonl sink's byte-compatibility
with the reference's records depends on it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class MetricKey:
    """One registered per-step scalar."""

    name: str
    description: str
    unit: str = ""            #: "", "s", "bytes", "devices", "count"
    required: bool = False    #: part of the ENGINE_METRIC_KEYS contract
    optional: bool = False    #: part of the ENGINE_OPTIONAL_METRIC_KEYS surface
    source: str = "core"      #: which layer emits it (see module doc)
    trace_counter: bool = False  #: render as a Perfetto counter track


#: The full registry, in contract order (see module doc on why order matters).
METRIC_KEYS: tuple = (
    # --- required contract (ENGINE_METRIC_KEYS order) -----------------------
    MetricKey("loss", "descent-lane loss at the (possibly perturbed) point",
              required=True, source="core", trace_counter=True),
    MetricKey("grad_norm", "global norm of the applied gradient",
              required=True, source="core"),
    MetricKey("tau", "age (steps) of the ascent gradient used for the "
              "perturbation (0 = none/synchronous, 1 = paper steady state)",
              unit="steps", required=True, source="lane", trace_counter=True),
    MetricKey("perturbed", "1.0 if the step used a SAM perturbation, 0.0 if "
              "it degraded to (or is) plain SGD",
              required=True, source="lane"),
    # --- optional wire/pool/elastic keys (ENGINE_OPTIONAL_METRIC_KEYS order)
    MetricKey("wire_bytes", "measured bytes of the harvested JOB+GRAD "
              "exchange (job + grad sum)", unit="bytes", optional=True,
              source="remote", trace_counter=True),
    MetricKey("job_bytes", "JOB frame bytes (params direction out: snapshot "
              "or delta-encoded bucket sections)", unit="bytes",
              optional=True, source="remote"),
    MetricKey("grad_bytes", "GRAD frame bytes (compressed ascent gradient "
              "back)", unit="bytes", optional=True, source="remote"),
    MetricKey("rtt_s", "round-trip seconds of the harvested exchange",
              unit="s", optional=True, source="remote"),
    MetricKey("pool_depth", "ascent-pool queue depth the exchange was "
              "admitted behind", optional=True, source="pool",
              trace_counter=True),
    MetricKey("pool_wait_s", "seconds the job waited before a pool worker "
              "took it", unit="s", optional=True, source="pool"),
    MetricKey("client_id", "numeric client identity (crc32 of the declared "
              "id) for joining fleet traces", optional=True, source="pool"),
    MetricKey("mesh_devices", "current mesh capacity in devices",
              unit="devices", optional=True, source="elastic",
              trace_counter=True),
    MetricKey("resize_events", "cumulative resize count, on the step right "
              "after a shrink/grow", unit="count", optional=True,
              source="elastic"),
    MetricKey("resize_time_s", "seconds the resize's re-place + re-lower "
              "cost", unit="s", optional=True, source="elastic"),
    MetricKey("lane_state", "ascent-lane degradation-ladder rung (0 = "
              "primary/remote, 1 = in-process thread lane, 2 = ledger-only "
              "descent); present when the ladder is enabled",
              optional=True, source="lane", trace_counter=True),
    MetricKey("lane_failovers", "cumulative ladder demotions, emitted on "
              "the step right after a failover", unit="count", optional=True,
              source="lane"),
    MetricKey("lane_recoveries", "cumulative ladder promotions, emitted on "
              "the step right after a recovery", unit="count", optional=True,
              source="lane"),
    MetricKey("guard_state", "numerics-guard de-escalation rung (0 = full "
              "rho ... last = plain descent); present when --guard is on",
              optional=True, source="guard", trace_counter=True),
    MetricKey("rho_scale", "effective-rho multiplier the guard rung applies "
              "(1.0 = undegraded, 0.0 = plain descent)", optional=True,
              source="guard"),
    MetricKey("steps_skipped", "cumulative updates the in-step guard "
              "discarded (non-finite loss/grad), emitted on skip steps",
              unit="count", optional=True, source="guard"),
    MetricKey("nonfinite_count", "non-finite elements in this step's "
              "gradient (0 on clean steps); emitted when guard_update is on",
              unit="count", optional=True, source="core"),
    MetricKey("poison_rollbacks", "cumulative PoisonBatch rollbacks (model "
              "restored, data cursor advanced), emitted on the step right "
              "after one", unit="count", optional=True, source="guard"),
    # --- method-level scalars (emitted by the step) -------------------------
    MetricKey("loss_at_w", "loss at the unperturbed point w (SAM two-point "
              "methods)", source="core"),
    MetricKey("ascent_loss", "loss the ascent pass observed; a NaN SENTINEL "
              "on fused-form reuse steps — real iff ascent_reused is 0",
              source="core"),
    MetricKey("ascent_reused", "1.0 when the fused async form reused the "
              "held ascent gradient instead of refreshing (AsyncSAM-k) — "
              "the flag that disambiguates the ascent_loss NaN sentinel",
              source="core"),
    MetricKey("ascent_norm", "global norm of the held ascent gradient",
              source="core"),
    MetricKey("update_skipped", "1.0 when the in-step numerics guard "
              "discarded this update (params/opt state kept)", source="core"),
    MetricKey("ascent_cosine", "cosine(a_t, a_{t-1}) of consecutive ascent "
              "gradients — the paper's Fig-2 staleness argument",
              source="core"),
    MetricKey("fresh", "1.0 when LookSAM recomputed g_v this step",
              source="core"),
    MetricKey("sam_step", "1.0 when AE-SAM took the SAM branch",
              source="core"),
    MetricKey("gnorm_sq", "squared gradient norm AE-SAM thresholds on",
              source="core"),
    MetricKey("mesa_kl", "Mesa-SAM distillation KL term", source="core"),
    # --- model-loss aux scalars (models/registry.py loss_fn aux) ------------
    MetricKey("ce", "cross-entropy term of the model loss (before aux "
              "penalties)", source="model"),
    MetricKey("moe_aux", "MoE load-balancing auxiliary loss term",
              source="model"),
    # --- engine-derived -----------------------------------------------------
    MetricKey("step_time_s", "wall seconds of the whole executor step, "
              "measured by the Engine fit loop", unit="s", source="engine"),
)

REGISTRY: dict = {k.name: k for k in METRIC_KEYS}

#: Keys every executor guarantees in its step metrics (derived; the engine
#: contract — see the per-key descriptions in METRIC_KEYS).
ENGINE_METRIC_KEYS: tuple = tuple(k.name for k in METRIC_KEYS if k.required)

#: Optional keys an executor MAY emit, only on steps where they are real
#: measurements (callbacks must tolerate their absence) — derived.
ENGINE_OPTIONAL_METRIC_KEYS: tuple = tuple(k.name for k in METRIC_KEYS
                                           if k.optional)

#: Keys a Chrome-trace sink additionally renders as counter tracks.
TRACE_COUNTER_KEYS: tuple = tuple(k.name for k in METRIC_KEYS
                                  if k.trace_counter)


class UnknownMetricError(KeyError):
    """A metric write used a key outside the registry."""


def metric_key(name: str) -> MetricKey:
    """Registry lookup; raises UnknownMetricError for unregistered names."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise UnknownMetricError(
            f"metric key {name!r} is not in the obs registry; declare it in "
            "repro_torch.obs.registry.METRIC_KEYS") from None


def validate_keys(keys: Iterable[str]) -> None:
    """Raise UnknownMetricError naming every unregistered key in `keys`."""
    unknown = sorted(k for k in keys if k not in REGISTRY)
    if unknown:
        raise UnknownMetricError(
            f"unregistered metric key(s) {unknown}; declare them in "
            "repro_torch.obs.registry.METRIC_KEYS")


def scalar_metrics(metrics: dict) -> dict:
    """The float()-able subset of a step's metrics, as host floats.

    The one filter every history/logging consumer applies (Engine, the
    resilient loop, LoggingCallback, the tracker route), kept in one place so
    metrics_history has the same shape on every execution path.
    """
    return {k: float(v) for k, v in metrics.items()
            if hasattr(v, "__float__") and getattr(v, "ndim", 0) == 0}


def registry_table() -> str:
    """The metric-key reference as a markdown table (README generator)."""
    rows = ["| key | source | unit | contract | description |",
            "|---|---|---|---|---|"]
    for k in METRIC_KEYS:
        contract = ("required" if k.required
                    else "optional" if k.optional else "")
        rows.append(f"| `{k.name}` | {k.source} | {k.unit or '—'} "
                    f"| {contract or '—'} | {k.description} |")
    return "\n".join(rows)
