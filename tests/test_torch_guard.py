"""Port parity for the numerics guard: the in-step skip (the epilogues'
`keep` flag and the per-leaf select), the carried ascent gradient of Form A,
the spike detector, NumericChaos, the GuardedExecutor ladder, the lane
executor's guard hooks, PoisonBatch rollback, the scripted chaos schedule,
and the reference's acceptance soak, each run on both packages.

Tolerances, per check: a skipped update leaves params and optimizer state
unchanged bit for bit (exact); the guard's discrete outputs (update_skipped,
nonfinite_count, the ladder's rungs and counters, the injectors' firing
sequences) are equal; losses and weights across the packages agree to rtol
2e-5 (fp32, the sums in another order), the soak's final loss to 2e-5
relative. Every tensor lies on the CPU: the kernels' own skip is held on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import optim as joptim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import MethodConfig as JMethodConfig
from repro.core import TrainState as JTrainState
from repro.core import init_train_state as jinit_train_state
from repro.core import make_method as jmake_method
from repro.runtime import GuardConfig as JGuardConfig
from repro.runtime import GuardedExecutor as JGuardedExecutor
from repro.runtime import ResilienceConfig as JResilienceConfig
from repro.runtime import SpikeDetector as JSpikeDetector
from repro.runtime import parse_numchaos as jparse_numchaos
from repro.runtime import parse_schedule as jparse_schedule
from repro.runtime import run_resilient as jrun_resilient
from repro.runtime.guard import NumericRule as JNumericRule
from repro.runtime.guard import _poison_batch as _jpoison_batch
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig, TrainState, init_train_state, make_method
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import Engine, FusedExecutor
from repro_torch.engine.callbacks import CheckpointCallback
from repro_torch.kernels import flat, ops, ref
from repro_torch.obs import MemorySink, Tracker
from repro_torch.runtime import (AsyncSamExecutor, ChaosSchedule, DeviceLoss, ExecutorConfig,
                                 GuardConfig, GuardedExecutor, InjectedFailure, MeshEvent,
                                 NumericChaos, NumericChaosPipeline, NumericRule, PoisonBatch,
                                 ResilienceConfig, SpikeDetector, parse_numchaos,
                                 parse_schedule, run_resilient)
from repro_torch.runtime.guard import _poison_batch
from repro_torch.utils import buckets, trees

RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the reference's float task (tests/test_guard.py), on both packages
# ---------------------------------------------------------------------------

def jlin_loss(params, batch, rng):
    logits = batch["x"] @ params["w"]
    onehot = jax.nn.one_hot(batch["y"], logits.shape[-1])
    return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1)), {}


def lin_loss(params, batch, gen=None):
    logits = batch["x"] @ params["w"]
    onehot = F.one_hot(batch["y"].long(), logits.shape[-1]).to(logits.dtype)
    return -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * onehot, dim=-1)), {}


def _w0() -> np.ndarray:
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (8, 4)) * 0.3, np.float32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaNs included."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _np_batch(i, n=32, nan=False):
    k = jax.random.PRNGKey(1000 + i)
    x = np.asarray(jax.random.normal(k, (n, 8)), np.float32)
    if nan:
        x = np.full_like(x, np.nan)
    y = np.asarray(jax.random.randint(jax.random.fold_in(k, 1), (n,), 0, 4))
    return {"x": x, "y": y}


def _tb(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _w(state) -> np.ndarray:
    p = state.params
    return (p.to_tree() if buckets.is_bucketed(p) else p)["w"].detach().numpy().copy()


def _opt_arrays(opt_state) -> list:
    return [t.detach().clone() for t in trees.tree_leaves(opt_state)]


class _Both:
    """One method on both packages, stepped on the same batches."""

    def __init__(self, mcfg: dict, opt: str, lr: float, resident=True, **okw):
        self.jmethod = jmake_method(JMethodConfig(**mcfg))
        jopt = getattr(joptim, opt)(lr, **okw)
        self.jstate = jinit_train_state({"w": jnp.asarray(_w0())}, jopt, self.jmethod,
                                        jax.random.PRNGKey(1))
        self.jstep = jax.jit(self.jmethod.make_step(jlin_loss, jopt))
        self.method = make_method(MethodConfig(**mcfg, fused_update=bool(resident)))
        o = getattr(optim, opt)(lr, **okw)
        self.state = init_train_state({"w": torch.from_numpy(_w0())}, o, self.method,
                                      resident=resident)
        self.step = self.method.make_step(lin_loss, o)

    def run(self, b: dict):
        self.state, m = self.step(self.state, _tb(b))
        self.jstate, jm = self.jstep(self.jstate, b)
        return m, jm


# ---------------------------------------------------------------------------
# the in-step guard (core/api._finish under guard_update)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resident", [True, False], ids=["fused", "per_leaf"])
def test_in_step_guard_skips_nonfinite_update_keeps_params(resident):
    both = _Both(dict(name="sgd", guard_update=True), "sgd", 0.1, resident, momentum=0.9)
    m, jm = both.run(_np_batch(0))
    assert float(m["update_skipped"]) == float(jm["update_skipped"]) == 0.0
    assert float(m["nonfinite_count"]) == float(jm["nonfinite_count"]) == 0.0
    before, opt_before = _w(both.state), _opt_arrays(both.state.opt_state)

    m, jm = both.run(_np_batch(1, nan=True))
    assert float(m["update_skipped"]) == float(jm["update_skipped"]) == 1.0
    assert float(m["nonfinite_count"]) == float(jm["nonfinite_count"]) > 0
    # params and optimizer state exactly as before the step, counters included
    np.testing.assert_array_equal(_w(both.state), before)
    for a, b in zip(_opt_arrays(both.state.opt_state), opt_before):
        assert torch.equal(a, b)
    assert both.state.step == int(both.jstate.step) == 2       # the batch is consumed

    m, jm = both.run(_np_batch(2))
    assert float(m["update_skipped"]) == 0.0 and np.isfinite(float(m["loss"]))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
    np.testing.assert_allclose(_w(both.state), np.asarray(both.jstate.params["w"]),
                               rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("name,opt", [("sam", "adamw"), ("gsam", "sgd")])
def test_in_step_guard_on_sam_and_gsam(name, opt):
    """The reference honours the guard for sgd, sam, gsam and async_sam."""
    both = _Both(dict(name=name, guard_update=True, rho=0.05), opt, 1e-2)
    both.run(_np_batch(0))
    before = _w(both.state)
    m, jm = both.run(_np_batch(1, nan=True))
    assert float(m["update_skipped"]) == float(jm["update_skipped"]) == 1.0
    assert float(m["nonfinite_count"]) == float(jm["nonfinite_count"])
    np.testing.assert_array_equal(_w(both.state), before)
    m, jm = both.run(_np_batch(2))
    np.testing.assert_allclose(_w(both.state), np.asarray(both.jstate.params["w"]),
                               rtol=RTOL, atol=1e-6)


def test_without_guard_nan_batch_poisons_params():
    both = _Both(dict(name="sgd"), "sgd", 0.1)
    m, jm = both.run(_np_batch(0, nan=True))
    assert "update_skipped" not in m and "update_skipped" not in jm
    assert not np.isfinite(_w(both.state)).all()
    assert not np.isfinite(np.asarray(both.jstate.params["w"])).all()


@pytest.mark.parametrize("resident", [True, False], ids=["fused", "per_leaf"])
def test_async_sam_guard_keeps_carried_ascent_finite(resident):
    both = _Both(dict(name="async_sam", rho=0.05, ascent_fraction=0.5, guard_update=True),
                 "adamw", 1e-3, resident)
    for i in range(3):
        both.run(_np_batch(i))
    held = float(both.state.method_state.ascent_norm)
    assert np.isfinite(held) and held > 0
    before, opt_before = _w(both.state), _opt_arrays(both.state.opt_state)
    carried = [t.clone() for t in trees.tree_leaves(both.state.method_state.ascent_grad)]

    m, jm = both.run(_np_batch(3, nan=True))
    ms, jms = both.state.method_state, both.jstate.method_state
    # the NaN refresh never entered the carried state: a_{t-1}, its norm,
    # have_ascent and the staleness are kept, as the reference keeps them
    assert float(ms.ascent_norm) == held
    assert float(ms.ascent_norm) == pytest.approx(float(jms.ascent_norm), rel=RTOL)
    for a, b in zip(trees.tree_leaves(ms.ascent_grad), carried):
        assert torch.equal(a, b)
    assert ms.have_ascent and ms.staleness == int(jms.staleness) == 1
    assert float(m["update_skipped"]) == float(jm["update_skipped"]) == 1.0
    assert float(m["nonfinite_count"]) == float(jm["nonfinite_count"])
    assert float(m["ascent_norm"]) == pytest.approx(float(jm["ascent_norm"]), rel=RTOL)
    np.testing.assert_array_equal(_w(both.state), before)
    for a, b in zip(_opt_arrays(both.state.opt_state), opt_before):
        assert torch.equal(a, b)

    m, jm = both.run(_np_batch(4))
    assert np.isfinite(float(m["loss"])) and float(m["perturbed"]) == 1.0
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
    np.testing.assert_allclose(_w(both.state), np.asarray(both.jstate.params["w"]),
                               rtol=RTOL, atol=1e-6)


def test_ascent_reused_flag_disambiguates_nan_sentinel():
    both = _Both(dict(name="async_sam", rho=0.05, ascent_fraction=0.5, ascent_interval=2),
                 "sgd", 0.05)
    seen = {0.0: [], 1.0: []}
    for i in range(6):
        m, jm = both.run(_np_batch(i))
        assert float(m["ascent_reused"]) == float(jm["ascent_reused"])
        seen[float(m["ascent_reused"])].append(float(m["ascent_loss"]))
    assert seen[1.0] and all(math.isnan(v) for v in seen[1.0])
    assert seen[0.0] and all(math.isfinite(v) for v in seen[0.0])


@pytest.mark.parametrize("kind", ["adamw", "sgd_momentum", "sgd_plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_plain_versions_keep_flag(kind, dtype, n=70_001):
    """The plain versions of the two epilogues take the kernels' flag: at 0
    the buffers are unchanged bit for bit, at 1 they compute what they
    compute without it (exact)."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    g[::7] = float("nan")
    mu = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    nu = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32))
    clip, lr = torch.tensor(0.7), torch.tensor(0.1)

    def run(keep, impl):
        bufs = [w.clone(), g.clone(), mu.clone(), nu.clone()]
        if kind == "adamw":
            ops.adamw_epilogue(*bufs, clip, lr, torch.tensor(0.1), torch.tensor(0.01),
                               weight_decay=1e-4, keep=keep, impl=impl)
        else:
            mom = 0.9 if kind == "sgd_momentum" else 0.0
            ops.sgd_epilogue(bufs[0], bufs[1], bufs[2], clip, lr, momentum=mom,
                             weight_decay=1e-4, keep=keep, impl=impl)
        return bufs

    for impl in ("plain", None):           # ops' plain route and the wrapper's
        skipped = run(torch.tensor(0.0), impl)
        assert all(_same_bits(a, b) for a, b in zip(skipped, (w, g, mu, nu)))
        kept, unflagged = run(torch.tensor(1.0), impl), run(None, impl)
        assert all(_same_bits(a, b) for a, b in zip(kept, unflagged))
        assert not _same_bits(kept[0], w)
    # the oracle functions themselves select per element
    new = ref.adamw_epilogue_flat_plain(w, g, mu, nu, clip, lr, 0.1, 0.01, keep=0.0)
    assert all(_same_bits(a, b) for a, b in zip(new, (w, mu, nu)))
    got = flat.sgd_epilogue_plain_(w.clone(), g, None, clip, lr, keep=torch.tensor(0.0))
    assert _same_bits(got[0], w) and got[1] is None


# ---------------------------------------------------------------------------
# SpikeDetector, NumericChaos
# ---------------------------------------------------------------------------

def test_spike_detector_scores_match_reference():
    rng = np.random.default_rng(3)
    det, jdet = SpikeDetector(window=16, min_samples=8), JSpikeDetector(window=16,
                                                                          min_samples=8)
    assert det.score(5.0) is None and jdet.score(5.0) is None
    for v in 2.0 + 0.05 * rng.standard_normal(40):
        det.observe(float(v))
        jdet.observe(float(v))
        for x in (1.7, float(v), 40.0, 0.5):
            assert det.score(x) == jdet.score(x)         # the same host arithmetic
    assert det.score(40.0) > 8.0 and det.score(0.5) < 0


def test_parse_numchaos_grammar_and_errors():
    spec = "nan_grad:nth=40:span=8,spike:prob=0.01:scale=1e4,inf_grad:every=50"
    nc, jnc = parse_numchaos(spec, seed=3), jparse_numchaos(spec, seed=3)
    assert [vars(r) if hasattr(r, "__dict__") else r for r in nc.rules] == \
        [vars(r) if hasattr(r, "__dict__") else r for r in jnc.rules]
    for bad, match in (("frobnicate:nth=1", "kind"), ("nan_grad:bogus=1", "unknown key"),
                       ("nan_grad:nth", "key=val"), (" , ", "empty")):
        with pytest.raises(ValueError, match=match):
            parse_numchaos(bad)


def test_numchaos_fires_the_reference_sequence_for_a_seed():
    spec = "spike:prob=0.2,nan_grad:nth=7:span=2,inf_grad:every=13"
    a, ja = parse_numchaos(spec, seed=9), jparse_numchaos(spec, seed=9)
    fires = [[a._fires(r, i, idx) for i, r in enumerate(a.rules)] for idx in range(300)]
    jfires = [[ja._fires(r, i, idx) for i, r in enumerate(ja.rules)] for idx in range(300)]
    assert fires == jfires
    assert any(f[0] for f in fires) and fires[7][1] and fires[8][1] and not fires[9][1]
    # replay: the same index re-fires (poison is a property of the data)
    assert a._fires(a.rules[1], 1, 7) and a._fires(a.rules[1], 1, 7)
    # and the injected batches: the same leaves poisoned, the same counters
    for idx in range(60):
        b = _np_batch(idx, n=4)
        out, jout = a.inject(idx, _tb(b)), ja.inject(idx, b)
        np.testing.assert_array_equal(out["x"].numpy(), np.asarray(jout["x"]))
        np.testing.assert_array_equal(out["y"].numpy(), np.asarray(jout["y"]))
    assert dict(a.fired) == dict(ja.fired) and a.skipped_no_float == ja.skipped_no_float


def test_poison_touches_float_leaves_only():
    batch = {"x": torch.ones(4, 8), "y": torch.arange(4), "ascent": {"x": torch.ones(2, 8)}}
    out, hit = _poison_batch(batch, NumericRule("nan_grad", nth=0))
    assert hit and torch.isnan(out["x"]).all() and torch.isnan(out["ascent"]["x"]).all()
    assert torch.equal(out["y"], torch.arange(4))
    _, hit = _poison_batch({"tokens": torch.arange(12).reshape(3, 4)},
                           NumericRule("nan_grad", nth=0))
    assert not hit
    out, _ = _poison_batch({"x": torch.full((2, 2), 2.0)}, NumericRule("spike", nth=0,
                                                                       scale=100.0))
    jout, _ = _jpoison_batch({"x": np.full((2, 2), 2.0, np.float32)},
                             JNumericRule("spike", nth=0, scale=100.0))
    np.testing.assert_array_equal(out["x"].numpy(), np.asarray(jout["x"]))


def test_numchaos_pipeline_cursor_state_and_uninjected_peek():
    inner = TokenPipeline(get_config("olmo-1b", reduced=True),
                          PipelineConfig(global_batch=2, seq_len=8, prefetch=0), device="cpu")
    chaos = parse_numchaos("nan_grad:nth=1", seed=0)
    pipe = NumericChaosPipeline(inner, chaos)
    assert "tokens" in pipe.peek()
    it = iter(pipe)
    next(it), next(it)
    st = pipe.state()
    assert st["cursor"] == 2 and "inner" in st
    pipe.restore({"cursor": 0, "inner": st["inner"]})
    assert pipe.state()["cursor"] == 0
    # token-only batches have no float leaves: the injection is a counted no-op
    assert chaos.fired.get("nan_grad", 0) == 0 and chaos.skipped_no_float == 1


# ---------------------------------------------------------------------------
# GuardedExecutor's ladder, on both packages with one scripted inner executor
# ---------------------------------------------------------------------------

class _FakeExec:
    """Inner executor whose metrics are scripted through the batch."""

    def __init__(self):
        self.rho_scales = []
        self.drops = 0
        self.closed = False

    def step(self, state, batch):
        return state._replace(step=state.step + 1), dict(batch["metrics"])

    def set_rho_scale(self, scale):
        self.rho_scales.append(scale)

    def drop_ascent(self):
        self.drops += 1

    def on_restore(self, state):
        return None

    def close(self):
        self.closed = True


def _m(loss=1.0, skipped=0.0, **kw):
    return {"loss": loss, "grad_norm": 1.0, "update_skipped": skipped, **kw}


_SCRIPTS = {
    "deescalate_recover": (dict(rho_scales=(1.0, 0.5, 0.0), demote_after=2, anomaly_window=4,
                                probation_steps=2, cooldown_steps=3, spike_min_samples=4,
                                rollback=False),
                           [_m(skipped=1.0)] * 5 + [_m()] * 40),
    "spike_stale": (dict(rho_scales=(1.0, 0.0), demote_after=2, anomaly_window=4,
                         spike_window=8, spike_min_samples=4, spike_zscore=8.0,
                         stale_norm_mult=10.0, stale_norm_min_samples=4, rollback=False),
                    [_m(loss=1.0 + 0.01 * (i % 3), ascent_norm=2.0) for i in range(8)]
                    + [_m(loss=500.0, ascent_norm=2.0), _m(ascent_norm=2000.0),
                       _m(ascent_norm=2.0), _m(ascent_norm=float("nan")),
                       _m(ascent_norm=2.0), _m(ascent_reused=1.0, ascent_loss=float("nan")),
                       _m(ascent_loss=float("nan"))] + [_m()] * 20),
    "bottom_rung_poison": (dict(rho_scales=(1.0, 0.0), demote_after=2, anomaly_window=4,
                                spike_min_samples=4, rollback=True),
                           [_m(skipped=1.0)] * 4 + [_m()] * 3),
    "severe_nonfinite": (dict(rollback=True), [_m(), _m(loss=float("nan")), _m()]),
}


def _script_run(guard_cls, cfg, inner, state, script, tensors):
    """Each step's (metrics or the PoisonBatch message), the hooks' calls."""
    g = guard_cls(inner, cfg)
    out = []
    for m in script:
        if tensors:
            m = {k: torch.tensor(v) for k, v in m.items()}
        try:
            state, got = g.step(state, {"metrics": m})
            out.append({k: float(v) for k, v in got.items()
                        if k in ("guard_state", "rho_scale", "steps_skipped",
                                 "poison_rollbacks")})
        except Exception as e:             # each package's own PoisonBatch
            assert type(e).__name__ == "PoisonBatch"
            out.append(str(e))
            g.on_restore(state)
    return out, (inner.rho_scales, inner.drops, g.ladder.level, g.ladder.failovers,
                 g.ladder.recoveries, g.steps_skipped, g.poison_rollbacks)


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_guarded_executor_ladder_matches_reference(name):
    """The same scripted metrics through both packages' GuardedExecutor give
    the same per-step telemetry, hook calls, rung and counters; the port's
    run reads device-scalar metrics (one transfer a step) as the reference
    reads floats."""
    cfg, script = _SCRIPTS[name]
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(0),
                         params={"w": jnp.zeros(2)}, opt_state=(), method_state=())
    state = TrainState(step=0, rng=0, params={"w": torch.zeros(2)}, opt_state=(),
                       method_state=())
    want = _script_run(JGuardedExecutor, JGuardConfig(**cfg), _FakeExec(), jstate, script,
                       False)
    assert _script_run(GuardedExecutor, GuardConfig(**cfg), _FakeExec(), state, script,
                       True) == want
    assert _script_run(GuardedExecutor, GuardConfig(**cfg), _FakeExec(), state, script,
                       False) == want


def test_guard_delegates_unknown_attrs_and_closes_inner():
    inner = _FakeExec()
    inner.mesh = "the-mesh"
    g = GuardedExecutor(inner, GuardConfig())
    assert g.mesh == "the-mesh"
    with pytest.raises(AttributeError):
        _ = g.nonesuch
    g.close()
    assert inner.closed


def test_guard_on_fused_form_a_rescales_the_carried_norm():
    """Fused Form A has no lane hook: a demotion rescales the carried norm by
    1/scale on the device, the bottom rung clears the host bool."""
    ex = FusedExecutor(lin_loss, MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5,
                                              guard_update=True), optim.sgd(0.05))
    g = GuardedExecutor(ex, GuardConfig(rho_scales=(1.0, 0.5, 0.0)))
    assert g._rho_hook is None and g._drop_hook is None
    state = g.init_state({"w": torch.from_numpy(_w0())}, 1)
    state, _ = g.step(state, _tb(_np_batch(0)))
    norm = state.method_state.ascent_norm.clone()
    g._scale = 0.5
    assert float(g._pre_step(state).method_state.ascent_norm) == float(norm / 0.5)
    g._scale = 0.0
    assert g._pre_step(state).method_state.have_ascent is False
    g._pending_drop = True
    dropped = g._pre_step(state).method_state
    assert dropped.have_ascent is False and dropped.staleness == 0


def test_rung_rescale_compounds_on_a_kept_carry_as_in_the_reference():
    """Reference fault 13 (ROADMAP.md): at a rung below 0, `_pre_step`
    divides the carried norm by the scale every step, and a skipped step
    keeps that divided norm, so each skip divides it again. The port does
    what the reference does; the sequences agree to rtol 2e-5."""
    kw = dict(name="async_sam", rho=0.05, ascent_fraction=0.5, guard_update=True)
    jopt = joptim.adamw(1e-3)
    jinner = _JMethodExec(JMethodConfig(**kw), jopt)
    jg = JGuardedExecutor(jinner, JGuardConfig(rho_scales=(1.0, 0.5, 0.0)))
    jstate = jinit_train_state({"w": jnp.asarray(_w0())}, jopt, jinner.method,
                               jax.random.PRNGKey(1))
    g = GuardedExecutor(FusedExecutor(lin_loss, MethodConfig(**kw), optim.adamw(1e-3)),
                        GuardConfig(rho_scales=(1.0, 0.5, 0.0)))
    state = g.init_state({"w": torch.from_numpy(_w0())}, 1)
    norms, jnorms = [], []
    for i in range(6):
        if i == 3:
            for x in (g, jg):
                x.ladder.level, x._scale = 1, 0.5
        b = _np_batch(i, nan=i >= 3)
        state, _ = g.step(state, _tb(b))
        jstate, _ = jg.step(jstate, b)
        norms.append(float(state.method_state.ascent_norm))
        jnorms.append(float(jstate.method_state.ascent_norm))
    np.testing.assert_allclose(norms, jnorms, rtol=RTOL)
    assert norms[4] == pytest.approx(4 * norms[2], rel=1e-6)    # two skips: divided twice


def test_executor_rho_scale_and_nonfinite_harvest_drop():
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5)
    opt = optim.sgd(0.05)
    method = make_method(mcfg)
    state = init_train_state({"w": torch.from_numpy(_w0())}, opt, method)
    # guard_update through the executor's override: the NaN descent batch
    # at step 6 skips instead of poisoning the params
    with AsyncSamExecutor(lin_loss, mcfg, opt,
                          ExecutorConfig(lockstep=True, guard_update=True)) as ex:
        assert ex.cfg.guard_update
        for i in range(4):
            state, m = ex.step(state, _tb(_np_batch(i)))
        assert float(m["perturbed"]) == 1.0 and m["ascent_norm"] > 0
        ex.set_rho_scale(0.0)
        state, m = ex.step(state, _tb(_np_batch(4)))
        assert float(m["perturbed"]) == 0.0
        ex.set_rho_scale(1.0)
        state, m = ex.step(state, _tb(_np_batch(5)))
        assert float(m["perturbed"]) == 1.0
        before = ex.nonfinite_drops
        state, m = ex.step(state, _tb(_np_batch(6, nan=True)))
        assert float(m["update_skipped"]) == 1.0
        state, m = ex.step(state, _tb(_np_batch(7)))
        state, m = ex.step(state, _tb(_np_batch(8)))
        assert ex.nonfinite_drops == before + 1
        assert np.isfinite(ex._held[1]) and np.isfinite(float(m["loss"]))
        ex.drop_ascent()
        assert ex._held is None and ex.ledger.tau == 0


# ---------------------------------------------------------------------------
# PoisonBatch rollback, the chaos schedule
# ---------------------------------------------------------------------------

class _CursorPipeline:
    """A stateful float-batch stream whose content is a function of the
    cursor, so replaying the stream replays the poison."""

    def __init__(self, n, chaos=None, torch_batches=True):
        self.n, self.chaos, self.torch_batches = n, chaos, torch_batches
        self._cursor = 0

    def state(self):
        return {"cursor": self._cursor}

    def restore(self, st):
        self._cursor = int(st["cursor"])

    def __iter__(self):
        while self._cursor < self.n:
            i = self._cursor
            self._cursor += 1
            b = _tb(_np_batch(i)) if self.torch_batches else _np_batch(i)
            yield self.chaos.inject(i, b) if self.chaos is not None else b


def _tiny_state():
    return TrainState(step=0, rng=0, params={"w": torch.zeros(3)},
                      opt_state={"m": torch.zeros(3)}, method_state={"a": torch.zeros(3)})


def test_poison_rollback_advances_cursor_past_the_window(tmp_path):
    def step_fn(state, batch):
        if torch.isnan(batch["x"]).any():
            raise PoisonBatch("poisoned batch content")
        return state._replace(step=state.step + 1), {"loss": torch.tensor(0.5)}

    pipe = _CursorPipeline(40, NumericChaos([NumericRule("nan_grad", nth=7)], seed=0))
    report = run_resilient(step_fn, _tiny_state(), pipe, CheckpointManager(tmp_path, keep=3),
                           12, ResilienceConfig(save_every=5, max_restarts=3,
                                                async_save=False))
    assert report.steps_done == 12
    assert report.poison_rollbacks == 1 and report.restarts == 1
    assert pipe.state()["cursor"] == 12 + 1 + 2


def test_chaos_schedule_matches_reference_and_drives_a_restart(tmp_path):
    spec = "2:4,5:2:crash,9:8"
    sched, jsched = parse_schedule(spec), jparse_schedule(spec)
    assert [dataclass_tuple(e) for e in sched.pending] == \
        [dataclass_tuple(e) for e in jsched.pending]
    with pytest.raises(ValueError, match="STEP:DEVICES"):
        parse_schedule("1:2:3:4")
    with pytest.raises(ValueError, match="kind"):
        MeshEvent(step=1, devices=2, kind="melt")
    # the failure-injector surface: resizes skipped, the crash raised once
    fired = []
    for s in (parse_schedule(spec), jparse_schedule(spec)):
        out = []
        for step in range(12):
            try:
                s(step)
                out.append(None)
            except Exception as e:         # each package's own DeviceLoss
                out.append((type(e).__name__, e.event.step, e.event.devices))
        fired.append(out)
    assert fired[0] == fired[1] and fired[0][5] == ("DeviceLoss", 5, 2)
    # Engine.fit(failure_injector=schedule): the crash restores a checkpoint
    method = make_method(MethodConfig(name="sgd"))
    ex = FusedExecutor(lin_loss, method, optim.sgd(0.1))
    state = ex.init_state({"w": torch.from_numpy(_w0())}, 0)
    cb = CheckpointCallback(CheckpointManager(tmp_path, keep=3),
                            ResilienceConfig(save_every=2, async_save=False))
    rep = Engine(ex, _CursorPipeline(40), [cb]).fit(
        state, 8, failure_injector=ChaosSchedule([MeshEvent(step=5, devices=2,
                                                            kind="crash")]))
    assert rep.steps_done == 8 and rep.restarts == 1
    assert issubclass(DeviceLoss, InjectedFailure)


def dataclass_tuple(e):
    return (e.step, e.devices, e.kind)


# ---------------------------------------------------------------------------
# the reference's acceptance soak, on both packages
# ---------------------------------------------------------------------------

_SOAK_SPEC = "nan_grad:nth=20,nan_grad:nth=40:span=8,spike:nth=90:span=2:scale=1e4"
_SOAK_GUARD = dict(rho_scales=(1.0, 0.5, 0.0), demote_after=2, anomaly_window=4,
                   probation_steps=4, cooldown_steps=4, spike_window=16,
                   spike_min_samples=8, rollback=True)
_SOAK_KEYS = ("guard_state", "rho_scale", "steps_skipped", "poison_rollbacks",
              "update_skipped", "nonfinite_count", "perturbed")


class _JMethodExec:
    def __init__(self, mcfg, opt):
        self.method = jmake_method(mcfg)
        self._step = jax.jit(self.method.make_step(jlin_loss, opt))

    def step(self, state, batch):
        return self._step(state, batch)

    def close(self):
        pass


def _soak(tmp_path, guarded: bool, n_steps=120):
    """The port's soak and the reference's: (report, guard, chaos) each."""
    kw = dict(name="async_sam", rho=0.05, ascent_fraction=0.5, guard_update=guarded)
    jopt = joptim.adamw(3e-3)
    jinner = _JMethodExec(JMethodConfig(**kw), jopt)
    jstate = jinit_train_state({"w": jnp.asarray(_w0())}, jopt, jinner.method,
                               jax.random.PRNGKey(1))
    opt = optim.adamw(3e-3)
    inner = FusedExecutor(lin_loss, MethodConfig(**kw), opt)
    state = inner.init_state({"w": torch.from_numpy(_w0())}, 1)
    out = []
    for pkg in ("port", "reference"):
        chaos = (parse_numchaos if pkg == "port" else jparse_numchaos)(_SOAK_SPEC, seed=0)
        pipe = _CursorPipeline(400, chaos, torch_batches=pkg == "port")
        if pkg == "port":
            guard = GuardedExecutor(inner, GuardConfig(**_SOAK_GUARD)) if guarded else None
            step = guard.step if guarded else inner.step
            report = run_resilient(
                step, state, pipe, CheckpointManager(tmp_path / pkg, keep=3), n_steps,
                ResilienceConfig(save_every=10, max_restarts=5, async_save=False,
                                 require_finite_restore=True),
                on_restore=guard.on_restore if guarded else None)
        else:
            guard = JGuardedExecutor(jinner, JGuardConfig(**_SOAK_GUARD)) if guarded else None
            step = guard.step if guarded else jinner.step
            report = jrun_resilient(
                step, jstate, pipe, JCheckpointManager(tmp_path / pkg, keep=3),
                n_steps=n_steps,
                rcfg=JResilienceConfig(save_every=10, max_restarts=5, async_save=False,
                                       require_finite_restore=True),
                on_restore=guard.on_restore if guarded else None)
        out.append((report, guard, chaos))
    return out


def test_acceptance_guarded_numchaos_soak_matches_reference(tmp_path):
    (rep, guard, chaos), (jrep, jguard, jchaos) = _soak(tmp_path, guarded=True)
    assert rep.steps_done == jrep.steps_done == 120
    assert dict(chaos.fired) == dict(jchaos.fired)
    assert chaos.fired["nan_grad"] >= 9 and chaos.fired["spike"] >= 1
    # the same guard events, step by step: skips, rungs, rollbacks
    hist, jhist = rep.metrics_history, jrep.metrics_history
    assert len(hist) == len(jhist)
    for i, (m, jm) in enumerate(zip(hist, jhist)):
        assert {k: m[k] for k in _SOAK_KEYS if k in m} == \
            {k: jm[k] for k in _SOAK_KEYS if k in jm}, i
    assert (rep.restarts, rep.poison_rollbacks) == (jrep.restarts, jrep.poison_rollbacks)
    assert rep.poison_rollbacks >= 1 and rep.restarts <= 5
    assert (guard.ladder.failovers, guard.ladder.recoveries, guard.steps_skipped) == \
        (jguard.ladder.failovers, jguard.ladder.recoveries, jguard.steps_skipped)
    assert max(m.get("steps_skipped", 0) for m in hist) >= 1
    assert max(m.get("guard_state", 0) for m in hist) >= 1 and hist[-1]["guard_state"] == 0
    # the final loss: finite, and the reference's to 2e-5 relative
    assert np.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] == pytest.approx(jhist[-1]["loss"], rel=2e-5)


def test_acceptance_same_injection_without_guard_diverges(tmp_path):
    (rep, _, _), (jrep, _, _) = _soak(tmp_path, guarded=False, n_steps=60)
    for r in (rep, jrep):
        assert not np.isfinite(r.metrics_history[-1]["loss"])
    assert not np.isfinite(_w(rep.final_state)).all()


def test_guarded_fit_logs_only_registered_keys():
    """The guarded fused executor under Engine.fit(tracker=...) with a strict
    sink: every key the guard and the in-step skip add is registered."""
    ex = FusedExecutor(lin_loss, MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5,
                                              guard_update=True), optim.adamw(1e-3))
    g = GuardedExecutor(ex, GuardConfig())
    sink = MemorySink(strict=True)
    state = g.init_state({"w": torch.from_numpy(_w0())}, 1)
    chaos = NumericChaos([NumericRule("nan_grad", nth=2)])
    Engine(g, _CursorPipeline(6, chaos)).fit(state, 6, tracker=Tracker([sink]))
    assert len(sink.steps) == 6
    assert [m["update_skipped"] for _, m in sink.steps] == [0, 0, 1, 0, 0, 0]
    assert sink.steps[2][1]["steps_skipped"] == 1.0
    assert {s.name for s in sink.spans} == {"train_step"}


# ---------------------------------------------------------------------------
# the launcher's resilience and observability flags
# ---------------------------------------------------------------------------

def _launch(*args, timeout=300):
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=root)


def test_launcher_guard_numchaos_trace_and_telemetry(tmp_path):
    import json
    r = _launch("--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "6",
                "--batch", "4", "--seq", "16", "--log-every", "3", "--guard",
                "--numchaos", "nan_grad:nth=5", "--trace", str(tmp_path / "t.json"),
                "--telemetry-jsonl", str(tmp_path / "t.jsonl"),
                "--ckpt-dir", str(tmp_path / "ck"), "--save-every", "3")
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "numchaos: 1 rules over the batch stream" in out
    assert "done: 6 steps, 0 restarts" in out
    # token batches carry no float leaf: the injection is a counted no-op
    assert "numchaos: fired {}, 1 no-float-leaf skips" in out
    assert "guard: rung 0 (rho_scale 1.0), 0 updates skipped, 0 poison rollbacks" in out
    assert "'guard_state': '0.0000'" in out and "'update_skipped': '0.0000'" in out
    recs = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [x["step"] for x in recs] == [1, 2, 3, 4, 5, 6]
    assert all(x["guard_state"] == 0.0 and x["nonfinite_count"] == 0.0 for x in recs)
    trace = json.loads((tmp_path / "t.json").read_text())
    assert sum(e["name"] == "train_step" for e in trace["traceEvents"]) == 6


def test_launcher_flag_checks_and_the_refused_elastic_flags(monkeypatch, capsys):
    from repro_torch.launch import train
    base = ["train", "--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "1"]
    cases = [((flag,), "item 7") for flag in ("--elastic", "--chaos=40:4", "--model-axis=2",
                                              "--resize-budget=3", "--resize-window-s=5")]
    cases += [(("--lane-ladder",), "--lane-ladder applies"),
              (("--netchaos", "drop:GRAD"), "--netchaos applies"),
              (("--watchdog",), "--watchdog restarts"),
              (("--executor", "remote", "--serve-ascent", "--watchdog", "--netchaos",
                "drop:GRAD"), "mutually exclusive")]
    for args, msg in cases:
        monkeypatch.setattr("sys.argv", base + list(args))
        with pytest.raises(SystemExit) as e:
            train.main()
        assert e.value.code == 2 and msg in capsys.readouterr().err, args
