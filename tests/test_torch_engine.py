"""Port parity for the Engine's callbacks (`repro_torch.engine.callbacks`):
the reference's `test_callbacks_meter_eval_and_logging`
(`tests/test_engine.py`) run on both packages, from the same weights on the
same batches: the throughput meter, `EvalCallback`'s cadence and curve, and
the logging callback's lines."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import MethodConfig as JMethodConfig
from repro.core import slice_ascent_batch as jax_slice_ascent_batch
from repro.data.synthetic import ClassificationTask as JClassificationTask
from repro.engine import Engine as JEngine
from repro.engine import EvalCallback as JEvalCallback
from repro.engine import FusedExecutor as JFusedExecutor
from repro.engine import LoggingCallback as JLoggingCallback
from repro.engine import ThroughputMeter as JThroughputMeter
from repro_torch import optim
from repro_torch.core import MethodConfig, slice_ascent_batch
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.engine import (Engine, EvalCallback, FusedExecutor, LoggingCallback,
                                ThroughputMeter)
from repro_torch.utils import buckets

TASK_KW = dict(n_classes=4, dim=8, seed=3)
STEPS, BATCH, EVERY = 10, 128, 5


def _jax_loss(params, batch, rng):
    h = jnp.tanh(batch["x"] @ params["w1"])
    logits = h @ params["w2"]
    onehot = jax.nn.one_hot(batch["y"], logits.shape[-1])
    loss = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))
    return loss, {"logits": logits}


def _loss(params, batch, gen):
    logits = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    loss = torch.nn.functional.cross_entropy(logits, batch["y"].long())
    return loss, {"logits": logits}


def _jax_params(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"w1": jax.random.normal(k, (8, 32)) * 0.3,
            "w2": jax.random.normal(jax.random.fold_in(k, 1), (32, 4)) * 0.3}


def _accuracy(logits, y) -> float:
    return float((logits.argmax(-1) == y).float().mean())


def _run_reference():
    task = JClassificationTask(**TASK_KW)
    val = task.valid_set()
    steps = []

    def eval_fn(st):
        steps.append(int(st.step))
        logits = _jax_loss(st.params, val, None)[1]["logits"]
        return float(jnp.mean(jnp.argmax(logits, -1) == val["y"]))

    meter = JThroughputMeter(tokens_per_batch=BATCH)
    evals = JEvalCallback(eval_fn, every=EVERY, total_steps=STEPS)
    batches = [{**b, "ascent": jax_slice_ascent_batch(b, 0.5)}
               for b in task.train_batches(BATCH, STEPS)]
    mcfg = JMethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5)
    with JFusedExecutor(_jax_loss, mcfg, joptim.sgd(0.1, momentum=0.9), donate=False) as ex:
        state = ex.init_state(_jax_params(), jax.random.PRNGKey(1))
        JEngine(ex, batches, [meter, evals, JLoggingCallback(every=EVERY)]).fit(state, STEPS)
    return meter, evals, steps


def _run_port():
    task = ClassificationTask(**TASK_KW)
    val = task.valid_set(device="cpu")
    steps = []

    def eval_fn(st):
        steps.append(int(st.step))
        params = st.params.to_tree() if buckets.is_bucketed(st.params) else st.params
        with torch.no_grad():
            return _accuracy(_loss(params, val, None)[1]["logits"], val["y"])

    meter = ThroughputMeter(tokens_per_batch=BATCH)
    evals = EvalCallback(eval_fn, every=EVERY, total_steps=STEPS)
    batches = [{**b, "ascent": slice_ascent_batch(b, 0.5)}
               for b in task.train_batches(BATCH, STEPS, device="cpu")]
    params = {k: torch.from_numpy(np.array(v)) for k, v in _jax_params().items()}
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5)
    with FusedExecutor(_loss, mcfg, optim.sgd(0.1, momentum=0.9)) as ex:
        state = ex.init_state(params, seed=1)
        Engine(ex, batches, [meter, evals, LoggingCallback(every=EVERY)]).fit(state, STEPS)
    return meter, evals, steps


def test_callbacks_meter_eval_and_logging(capsys):
    """The reference's assertions on each package, and the two curves
    against each other: the same eval steps (5 and 10) and the same
    accuracies on the same weights (argmax of logits within 2e-5 of each
    other: no prediction flips on this task)."""
    results = {}
    for name, run in (("reference", _run_reference), ("port", _run_port)):
        meter, evals, steps = run()
        assert len(meter.step_times) == STEPS
        assert meter.summary()["tokens_per_s"] > 0
        assert len(evals.curve) >= 2
        assert all(0.0 <= acc <= 1.0 for _, acc in evals.curve)
        assert "step " in capsys.readouterr().out
        results[name] = (steps, [acc for _, acc in evals.curve], [t for t, _ in evals.curve])
    (jsteps, jaccs, _), (steps, accs, times) = results["reference"], results["port"]
    assert steps == jsteps == [EVERY, STEPS]
    assert accs == pytest.approx(jaccs, abs=1e-12)
    assert times == sorted(times) and times[0] >= 0.0


def test_eval_callback_cadence():
    """every=3 over 7 steps evaluates at 3 and 6, and at total_steps 7."""
    seen = []
    cb = EvalCallback(lambda st: float(len(seen)), every=3, total_steps=7)
    cb.on_fit_start(None, None)

    class St:
        def __init__(self, step):
            self.step = step

    for step in range(1, 8):
        before = len(cb.curve)
        cb.on_step(None, St(step), {}, 0.0)
        if len(cb.curve) > before:
            seen.append(step)
    assert seen == [3, 6, 7]
    assert [v for _, v in cb.curve] == [0.0, 1.0, 2.0]
    assert EvalCallback(lambda st: 0.0, every=0).every == 1
