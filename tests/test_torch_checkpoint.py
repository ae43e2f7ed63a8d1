"""Port parity for checkpoint-restart: `repro_torch.checkpoint` against the
reference's behaviour (tests/test_data_checkpoint.py, tests/test_netchaos.py)
and on-disk format (a checkpoint written by either package restores in the
other, with the same leaf paths and crc32s), `run_resilient` through
`Engine.fit`, and the launcher's `--ckpt-dir`.

The reference's TrainState.rng is a PRNG key (uint32[2]) and the port's an
int seed, so cross-package restores are held for params, opt_state and
method_state. Every tensor here lies on the CPU.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.core import MethodConfig as JMethodConfig
from repro.engine import FusedExecutor as JFusedExecutor
from repro.models import build_model as jax_build_model
from repro.utils import buckets as jbuckets
from repro_torch import optim
from repro_torch.checkpoint import CheckpointIntegrityError, CheckpointManager
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig, TrainState
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import CheckpointCallback, Engine, FusedExecutor
from repro_torch.models import build_model
from repro_torch.runtime import (InjectedFailure, ResilienceConfig, RestartBudget,
                                 run_resilient)
from repro_torch.utils import buckets, trees

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g), "b": torch.full((4,), float(seed))},
            "opt": {"mu": torch.ones((8, 4))},
            "step": seed}


def _equal(a, b) -> bool:
    la, lb = trees.tree_leaves({k: v for k, v in a.items() if k != "step"}), \
        trees.tree_leaves({k: v for k, v in b.items() if k != "step"})
    return a["step"] == b["step"] and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the manager (tests/test_data_checkpoint.py, tests/test_netchaos.py)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_exact(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    st = _state(7)
    mgr.save(7, st, extras={"pipeline": {"step": 7, "seed": 0}})
    st["params"]["w"].zero_()                     # the saved copy is the host's own
    restored, extras = mgr.restore(_state(0))
    assert _equal(restored, _state(7)) and extras["pipeline"]["step"] == 7
    assert isinstance(restored["step"], int)


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    restored, _ = mgr.restore(_state(0))
    assert _equal(restored, _state(4))
    restored, _ = mgr.restore(_state(0), step=3)
    assert _equal(restored, _state(3))


def test_checkpoint_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _state(1), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1
    assert _equal(mgr.restore(_state(0))[0], _state(1))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state())
    bad = _state()
    bad["params"]["w"] = torch.zeros((9, 4))
    with pytest.raises(ValueError, match="ckpt"):
        mgr.restore(bad)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(), step=0)


def _flip_last_byte(path: pathlib.Path) -> None:
    raw = bytearray(path.read_bytes())
    raw[-4] ^= 0xFF
    path.write_bytes(bytes(raw))


def test_corrupt_and_truncated_checkpoints_fall_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    for s in (1, 2, 3):
        mgr.save(s, _state(s))
    _flip_last_byte(next((tmp_path / "step_00000003" / "arrays").glob("*w.npy")))
    assert not mgr.verify_step(3) and mgr.verify_step(2)
    assert _equal(mgr.restore(_state(0))[0], _state(2))
    victim = next((tmp_path / "step_00000002" / "arrays").glob("*.npy"))
    victim.write_bytes(victim.read_bytes()[:10])                      # torn write
    assert _equal(mgr.restore(_state(0))[0], _state(1))
    victim.unlink()                               # fails the manifest-level check too
    assert mgr.all_steps() == [1, 3] and not mgr.verify_step(2)
    mani = tmp_path / "step_00000001" / "manifest.json"
    mani.write_text(mani.read_text().replace('"step": 1', '"step": 10'))
    assert mgr.all_steps() == [3]                 # the checksum sibling catches the edit


def test_all_checkpoints_corrupt_raises_integrity_error(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, _state(1))
    for f in (tmp_path / "step_00000001" / "arrays").glob("*.npy"):
        _flip_last_byte(f)
    with pytest.raises(CheckpointIntegrityError):
        mgr.restore(_state(0))


def test_legacy_checkpoint_without_checksums_still_restores(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, _state(1))
    d = tmp_path / "step_00000001"
    manifest = json.loads((d / "manifest.json").read_text())
    for rec in manifest["leaves"]:
        rec.pop("crc32", None)
    (d / "manifest.json").write_text(json.dumps(manifest))
    (d / "manifest.crc32").unlink()
    assert mgr.all_steps() == [1]
    assert _equal(mgr.restore(_state(0))[0], _state(1))


def test_require_finite_skips_a_diverged_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, _state(1))
    bad = _state(2)
    bad["params"]["w"][0, 0] = float("nan")
    mgr.save(2, bad)
    assert torch.isnan(mgr.restore(_state(0))[0]["params"]["w"][0, 0])
    assert _equal(mgr.restore(_state(0), require_finite=True)[0], _state(1))


def test_async_save_error_surfaces_from_wait_and_next_save(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, _state(1))
    real_save, mode = manager_mod.np.save, ["boom"]

    def maybe_boom(path, arr):
        if mode[0] == "boom":
            raise OSError("disk full")
        return real_save(path, arr)

    monkeypatch.setattr(manager_mod.np, "save", maybe_boom)
    mgr.save(2, _state(2), blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    mgr.wait()                                    # raised once, then cleared
    mgr.save(3, _state(3), blocking=False)
    mgr._worker.join()                            # failure captured before the heal
    mode[0] = "ok"
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.save(4, _state(4), blocking=False)
    assert mgr.all_steps() == [1]                 # failed steps never became visible


class _ListPipeline:
    def __init__(self, batches):
        self._batches = batches

    def __iter__(self):
        return iter(self._batches)

    def state(self):
        return {"cursor": 0}

    def restore(self, cursor):
        pass


def test_run_resilient_spends_a_restart_on_async_save_error(tmp_path, monkeypatch):
    real_save, fails, armed = manager_mod.np.save, [0], [True]

    def flaky_save(path, arr):
        if fails[0]:
            fails[0] -= 1
            raise OSError("disk full")
        return real_save(path, arr)

    monkeypatch.setattr(manager_mod.np, "save", flaky_save)

    def step_fn(state, batch):
        if state.step == 4 and armed[0]:
            armed[0] = False
            fails[0] = 1                          # poison the NEXT async save (step 5)
        return state._replace(step=state.step + 1), {"loss": torch.tensor(0.5)}

    state = TrainState(step=0, rng=0, params={"w": torch.zeros(3)},
                       opt_state={"m": torch.zeros(3)}, method_state={"a": torch.zeros(3)})
    report = run_resilient(step_fn, state, _ListPipeline([{}] * 40),
                           CheckpointManager(tmp_path, keep=5), n_steps=12,
                           rcfg=ResilienceConfig(save_every=5, max_restarts=3, async_save=True))
    assert report.steps_done == 12 and report.restarts == 1
    # a rolling window forgets old restarts: each spend() reads the clock twice
    budget = RestartBudget(1, window_s=10.0,
                           clock=iter([0.0, 1.0, 20.0, 21.0, 22.0, 23.0]).__next__)
    assert budget.spend() == 1 and budget.spend() == 1
    with pytest.raises(RuntimeError, match="within 10s window"):
        budget.spend()
    assert budget.total == 3


# ---------------------------------------------------------------------------
# the on-disk format against the reference's
# ---------------------------------------------------------------------------

def test_bf16_leaves_cross_bit_for_bit(tmp_path):
    bits = np.random.default_rng(0).integers(0, 2**16, 37, dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80       # no NaN/Inf patterns
    ref_arr = bits.view(ml_dtypes.bfloat16)
    JCheckpointManager(tmp_path / "ref").save(1, {"w": jnp.asarray(ref_arr)})
    got, _ = CheckpointManager(tmp_path / "ref").restore({"w": torch.zeros(37, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy().view(np.uint16), bits)
    # the port writes what the reference writes: descr, dtype name, crc
    CheckpointManager(tmp_path / "port").save(1, {"w": got["w"]})
    for root in ("ref", "port"):
        d = tmp_path / root / "step_00000001"
        assert b"'descr': '<V2'" in (d / "arrays" / "w.npy").read_bytes()[:128]
        rec = json.loads((d / "manifest.json").read_text())["leaves"][0]
        assert rec["dtype"] == "bfloat16" and rec["crc32"] == manager_mod._leaf_crc(bits)
    # the reference cannot read a bf16 leaf back (numpy gives |V2, which has no cast
    # to bfloat16); the port reads both
    with pytest.raises(ValueError, match="No cast function"):
        JCheckpointManager(tmp_path / "port").restore(
            jax.eval_shape(lambda: {"w": jnp.zeros(37, jnp.bfloat16)}))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's AsyncSAM + sgd(momentum, wd, clip) state after 2 steps on
    olmo-1b-reduced, and a reference state of the same structure."""
    cfg, jcfg = get_config("olmo-1b", reduced=True), jax_get_config("olmo-1b", reduced=True)
    opt_kw = dict(momentum=0.9, nesterov=True, weight_decay=1e-4, clip_norm=1.0)
    bundle = build_model(cfg)
    ex = FusedExecutor(bundle.loss_fn, MethodConfig(name="async_sam", rho=0.05),
                       optim.sgd(0.05, **opt_kw))
    state = ex.init_state(bundle.init(0, "cpu"), seed=1)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=4, seq_len=32, seed=0,
                                             ascent_fraction=0.25, prefetch=0), device="cpu")
    state = Engine(ex, pipe).fit(state, 2).final_state
    jex = JFusedExecutor(jax_build_model(jcfg).loss_fn, JMethodConfig(name="async_sam"),
                         joptim.sgd(0.05, **opt_kw), mesh=None, fused_update=True,
                         resident=True)
    jstate = jex.init_state(jax_build_model(jcfg).init(jax.random.PRNGKey(0)),
                            jax.random.PRNGKey(1))
    return state, jstate


_PARTS = ("params", "opt_state", "method_state")


def _manifest(root: pathlib.Path, step: int) -> dict:
    leaves = json.loads((root / f"step_{step:08d}" / "manifest.json").read_text())["leaves"]
    return {r["path"]: (r["shape"], r["dtype"], r["crc32"]) for r in leaves}


def test_checkpoints_cross_between_the_packages(trained, tmp_path):
    state, jstate = trained
    # the port writes its whole state; the reference's paths are the port's
    CheckpointManager(tmp_path / "port").save(2, state)
    port = _manifest(tmp_path / "port", 2)
    jportable = jbuckets.to_portable(jstate)
    from repro.utils import trees as jtrees
    assert list(port) == jtrees.tree_paths(jportable)
    assert port["rng"][0] == [] and port["step"] == ([], "int32", port["step"][2])
    # the reference restores the port's params/opt_state/method_state ...
    jlike = jax.eval_shape(lambda: {k: getattr(jportable, k) for k in _PARTS})
    jrestored, _ = JCheckpointManager(tmp_path / "port").restore(jlike)
    # ... and writes them back with the same paths and crc32s
    JCheckpointManager(tmp_path / "ref").save(2, jrestored)
    ref = _manifest(tmp_path / "ref", 2)
    assert ref == {p: v for p, v in port.items() if p.split("/")[0] in _PARTS}
    # the port restores the reference-written checkpoint bit for bit
    like = {k: getattr(state, k) for k in _PARTS}
    restored, _ = CheckpointManager(tmp_path / "ref").restore(like)
    expect = buckets.to_portable(like)
    for part in _PARTS:
        a, b = _tensors(restored[part]), _tensors(expect[part])
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), part
    assert restored["method_state"].have_ascent is True
    assert restored["method_state"].staleness == 1


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


# ---------------------------------------------------------------------------
# run_resilient through Engine.fit, and the launcher
# ---------------------------------------------------------------------------

def _fit(tmp, fail_at, resident=True, steps=6):
    cfg = get_config("olmo-1b", reduced=True)
    bundle = build_model(cfg)
    ex = FusedExecutor(bundle.loss_fn, MethodConfig(name="async_sam", rho=0.05),
                       optim.sgd(optim.cosine_schedule(0.1, steps), momentum=0.9),
                       resident=resident)
    model = bundle.init(0, "cpu")
    state = ex.init_state(model, seed=1)
    live = trees.tree_leaves(state.params)
    live_m = trees.tree_leaves(state.opt_state[0].momentum)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=4, seq_len=32, seed=0,
                                             ascent_fraction=0.25), device="cpu")
    fired = []

    def inject(step):
        if step == fail_at and not fired:
            fired.append(step)
            raise InjectedFailure(f"node lost before step {step}")

    cbs = ([CheckpointCallback(CheckpointManager(tmp, keep=3), ResilienceConfig(save_every=3))]
           if fail_at is not None else [])
    rep = Engine(ex, pipe, cbs).fit(state, steps, failure_injector=inject)
    final = rep.final_state
    # restored INTO the live buffers: the model's parameters still view them
    assert all(a is b for a, b in zip(trees.tree_leaves(final.params), live))
    assert all(a is b for a, b in zip(trees.tree_leaves(final.opt_state[0].momentum), live_m))
    batch = pipe.peek()
    loss_model, _ = bundle.loss_fn(model, batch)
    loss_state, _ = bundle.loss_fn(buckets.to_portable(final.params), batch)
    assert torch.equal(loss_model, loss_state)
    return rep


@pytest.fixture
def one_thread():
    """One intra-op thread: with several, the CPU's matrix products may split
    their sums another way while the asynchronous save's worker thread runs
    (the card's kernels do not), and two runs would differ in the last bit."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "per_leaf"])
def test_run_resilient_restart_is_bitwise_the_uninterrupted_run(tmp_path, resident,
                                                                one_thread):
    clean = _fit(tmp_path / "a", None, resident)
    crashed = _fit(tmp_path / "b", 4, resident)
    assert (clean.restarts, crashed.restarts) == (0, 1)
    assert crashed.steps_done == clean.steps_done == 6
    assert sorted(int(p.name[5:]) for p in (tmp_path / "b").glob("step_*")) == [0, 3, 6]
    a, b = clean.final_state, crashed.final_state
    for x, y in ((a.params, b.params), (a.opt_state[0].momentum, b.opt_state[0].momentum),
                 (a.method_state.ascent_grad, b.method_state.ascent_grad)):
        for u, v in zip(trees.tree_leaves(x), trees.tree_leaves(y)):
            assert torch.equal(u, v)
    assert clean.metrics_history[-1] == crashed.metrics_history[-1]
    manifest = json.loads((tmp_path / "b" / "step_00000006" / "manifest.json").read_text())
    assert manifest["extras"]["pipeline"]["step"] == 6
    assert ("bucket_layout" in manifest["extras"]) == resident
    with pytest.raises(ValueError, match="warmup"):
        Engine(None, [], [CheckpointCallback(CheckpointManager(tmp_path / "c"))]).fit(
            None, 1, warmup=1)


def test_train_cli_checkpoints_and_finishes(tmp_path):
    """The reference's end-to-end launcher arguments (tests/test_system.py),
    on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--reduced",
         "--device", "cpu", "--method", "async_sam", "--steps", "12", "--batch", "4",
         "--seq", "32", "--save-every", "6", "--ckpt-dir", str(tmp_path / "run")],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "done: 12 steps, 0 restarts" in proc.stdout
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "step_00000000", "step_00000006", "step_00000012"]


def test_engine_fit_warmup_steps_before_the_callbacks():
    """warmup steps run before on_fit_start and are not in the history; the
    loop then trains until state.step == steps (the reference's semantics)."""
    from repro_torch.engine import Callback

    class Counting:
        def step(self, state, batch):
            return state._replace(step=state.step + 1), {"loss": torch.tensor(1.0)}

        def close(self):
            pass

    class Seen(Callback):
        def __init__(self):
            self.start = None
            self.steps = []

        def on_fit_start(self, engine, state):
            self.start = state.step

        def on_step(self, engine, state, metrics, step_time_s):
            self.steps.append(state.step)

    seen = Seen()
    state = TrainState(step=0, rng=0, params={"w": torch.zeros(1)}, opt_state=(),
                       method_state=())
    report = Engine(Counting(), [{}] * 10, [seen]).fit(state, 5, warmup=2)
    assert seen.start == 2 and seen.steps == [3, 4, 5]
    assert report.steps_done == 5 and len(report.metrics_history) == 3


@pytest.mark.parametrize("first", ["repro_torch.runtime", "repro_torch.checkpoint",
                                   "repro_torch.engine"])
def test_each_package_imports_first_in_a_fresh_process(first):
    """The checkpoint-restart packages sit below the engine: importing any of
    them first works (no import cycle through `repro_torch.engine`)."""
    proc = subprocess.run([sys.executable, "-c", f"import {first}"], capture_output=True,
                          text=True, timeout=120, env=dict(os.environ,
                                                           PYTHONPATH=str(REPO / "src")),
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr

