"""The elastic executor in one process (tests/test_elastic.py's in-process
cases on the port): resident state against sharded meshes, the resize
budget, unsatisfiable resizes, the engine's event plumbing, the hetero and
remote lanes' resize, the single-device elastic path the card runs (a
resize to 1 device, a skipped grow, a crash restored onto the survivor: bit
for bit the uninterrupted run), and `launch.steps.make_train_setup` against
the reference's. Multi-rank runs are in tests/test_torch_distributed*.py.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core import MethodConfig as JMethodConfig
from repro.launch.steps import make_train_setup as jax_make_train_setup
from repro.models import build_model as jax_build_model
from repro.models import synth_batch as jax_synth_batch
from repro.utils.trees import tree_map_with_path as jax_tree_map_with_path
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig, slice_ascent_batch
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.engine import (CheckpointCallback, ElasticExecutor, Engine, FusedExecutor,
                                HeteroExecutor, RemoteExecutor, StalenessTelemetry)
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_setup)
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_jax, to_reference
from repro_torch.runtime import (ChaosSchedule, DeviceLoss, ExecutorConfig, MeshEvent,
                                 ResilienceConfig, make_sized_mesh, reshard_state)
from repro_torch.service.testing import MLP_LOSS_SPEC, mlp_init, mlp_loss
from repro_torch.utils import buckets


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


TASK = ClassificationTask(n_classes=4, dim=8, seed=3)


def _batches(n, frac=0.5):
    return [{**b, "ascent": slice_ascent_batch(b, frac)}
            for b in TASK.train_batches(64, n, device="cpu")]


def _hetero_elastic(**kw):
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5)
    return ElasticExecutor(
        HeteroExecutor(mlp_loss, mcfg, optim.sgd(0.1, momentum=0.9),
                       exec_cfg=ExecutorConfig(descent_device="cpu")), **kw)


# ---------------------------------------------------------------------------
# resident state and sharded meshes
# ---------------------------------------------------------------------------

def test_reshard_resident_onto_sharded_mesh_raises():
    st = buckets.BucketedState.from_tree({"w": torch.ones(4)})
    with pytest.raises(ValueError, match="bucket-resident"):
        reshard_state({"params": st}, None, Mesh(("data", "model"), (8, 1)))
    # unsharded targets pass through / re-place without complaint
    assert reshard_state({"params": st}, None, None)["params"] is st
    moved = reshard_state({"params": st}, None, make_sized_mesh(1, device="cpu"))["params"]
    assert torch.equal(moved.buffers[0], st.buffers[0])


def test_fused_executor_resolves_and_refuses_by_mesh():
    mcfg = MethodConfig(name="async_sam")
    cfg = get_config("olmo-1b", reduced=True)
    eight = Mesh(("data", "model"), (4, 2))
    ex = FusedExecutor(mlp_loss, mcfg, optim.adamw(1e-3), mesh=eight, model_cfg=cfg)
    assert not ex.fused_update and not ex.resident
    one = FusedExecutor(mlp_loss, mcfg, optim.adamw(1e-3),
                        mesh=make_host_mesh(device="cpu"), model_cfg=cfg)
    assert one.fused_update and one.resident
    with pytest.raises(ValueError, match="bucket-resident state needs an unsharded step"):
        FusedExecutor(mlp_loss, mcfg, optim.adamw(1e-3), mesh=eight, model_cfg=cfg,
                      resident=True)
    with pytest.raises(ValueError, match="ModelConfig"):
        FusedExecutor(mlp_loss, mcfg, optim.adamw(1e-3), mesh=eight)
    # a resident step resizes onto one device (and drops its mesh), never more
    state = one.init_state(mlp_init(0, device="cpu"), 1)
    bufs = state.params.buffers
    state = one.resize(state, make_sized_mesh(1, device="cpu"))
    assert one.mesh is None and all(a is b for a, b in zip(state.params.buffers, bufs))
    with pytest.raises(ValueError, match="cannot resize onto a sharded mesh"):
        one.resize(state, eight)


def test_host_mesh_without_a_process_group():
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert not mesh.live and not mesh.sharded and mesh.is_member
    with pytest.raises(ValueError, match="model_axis=2"):
        make_host_mesh(model_axis=2, device="cpu")
    with pytest.raises(ValueError, match="only 1 are attached"):
        make_sized_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        make_sized_mesh(1, model_axis=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_host_mesh()


# ---------------------------------------------------------------------------
# the elastic executor, meshless family: resize = lane resync, budget enforced
# ---------------------------------------------------------------------------

def test_elastic_hetero_resize_emits_telemetry():
    sched = ChaosSchedule([MeshEvent(step=5, devices=4)])
    with Engine(_hetero_elastic(), _batches(12)) as eng:
        state = eng.executor.init_state(mlp_init(0, device="cpu"), 1)
        rep = eng.fit(state, 12, events=sched)
    assert rep.steps_done == 12
    assert eng.executor.resize_events == 1
    hist = rep.metrics_history
    assert all("mesh_devices" in m for m in hist)
    marked = [m for m in hist if "resize_events" in m]
    assert len(marked) == 1 and marked[0]["mesh_devices"] == 4.0
    assert marked[0]["resize_time_s"] >= 0.0
    assert np.isfinite(hist[-1]["loss"])


def test_elastic_resize_budget_exhaustion_raises():
    sched = ChaosSchedule([MeshEvent(2, 4), MeshEvent(4, 8), MeshEvent(6, 2)])
    with _hetero_elastic(resize_budget=2) as ex, \
            pytest.raises(RuntimeError, match="resize budget"):
        state = ex.init_state(mlp_init(0, device="cpu"), 1)
        Engine(ex, _batches(10)).fit(state, 10, events=sched)


def test_unsatisfiable_graceful_resize_skips_without_killing_the_fit():
    # a mesh-building elastic wrapper asked to grow past the world: the event
    # is skipped with a warning, no budget spent, the fit lives
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5)
    inner = HeteroExecutor(mlp_loss, mcfg, optim.sgd(0.1, momentum=0.9),
                           exec_cfg=ExecutorConfig(descent_device="cpu"))
    ex = ElasticExecutor(inner, meshless=False, resize_budget=1)
    sched = ChaosSchedule([MeshEvent(2, 64), MeshEvent(4, 4096)])
    with Engine(ex, _batches(6)) as eng:
        state = ex.init_state(mlp_init(0, device="cpu"), 1)
        rep = eng.fit(state, 6, events=sched)
    assert rep.steps_done == 6 and rep.restarts == 0
    assert ex.resize_events == 0          # skipped events spend no budget
    assert all(m["mesh_devices"] == 1.0 for m in rep.metrics_history)


def test_engine_rejects_event_source_on_non_elastic_executor():
    class Poller:                       # poll() but not callable
        def poll(self, step):
            return None

    ex = FusedExecutor(mlp_loss, MethodConfig(name="sgd"), optim.sgd(0.1))
    with Engine(ex, _batches(1)) as eng:
        state = ex.init_state(mlp_init(0, device="cpu"), 1)
        with pytest.raises(ValueError, match="ElasticExecutor"):
            eng.fit(state, 1, events=Poller())
        # a callable source takes the failure injector's place
        with pytest.raises(ValueError, match="not both"):
            eng.fit(state, 1, events=ChaosSchedule([MeshEvent(0, 1)]),
                    failure_injector=lambda step: None)


def test_remote_resize_keeps_ascent_pool_serving(tmp_path):
    """A descent resize invalidates the client's JobEncoder shadow: the next
    JOB is a full snapshot, the delta stream resumes, the server process is
    the same one throughout."""
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5)
    xcfg = ExecutorConfig(lockstep=True, serve_ascent=True, loss_spec=MLP_LOSS_SPEC,
                          job_compress="int8", job_delta=True, descent_device="cpu")
    jsonl = tmp_path / "elastic_remote.jsonl"
    tel = StalenessTelemetry(print_summary=False, jsonl_path=jsonl)
    resize_at = 8
    sched = ChaosSchedule([MeshEvent(step=resize_at, devices=1)])
    ex = RemoteExecutor(mlp_loss, mcfg, optim.sgd(0.1, momentum=0.9), exec_cfg=xcfg)
    el = ElasticExecutor(ex)
    pid = ex.server.proc.pid
    with Engine(el, _batches(16), [tel]) as eng:
        state = el.init_state(mlp_init(0, device="cpu"), 1)
        rep = eng.fit(state, 16, events=sched)
        assert ex.server_respawns == 0
        assert ex.server.proc.pid == pid and ex.server.alive()
        enc = ex.client.job_encoder
        assert enc.snapshot_jobs >= 2, enc.snapshot_jobs
        assert enc.delta_jobs >= 2, enc.delta_jobs
    assert rep.steps_done == 16 and el.resize_events == 1
    assert np.isfinite(rep.metrics_history[-1]["loss"])
    recs = [json.loads(x) for x in jsonl.read_text().splitlines()]
    marked = [r for r in recs if "resize_events" in r]
    assert len(marked) == 1 and marked[0]["step"] == resize_at + 1
    jb = [(r["step"], r["job_bytes"]) for r in recs if "job_bytes" in r]
    pre = [b for s, b in jb if s <= resize_at]
    post = [b for s, b in jb if s > resize_at]
    assert pre and post
    snap, delta = max(pre), min(pre)
    assert snap > 1.3 * delta, (snap, delta)       # a snapshot outweighs an int8 delta
    assert max(post) >= snap, (max(post), snap)    # the resync snapshot
    assert min(post) <= delta, (min(post), delta)  # then deltas again


# ---------------------------------------------------------------------------
# the single-device elastic path (what the card runs)
# ---------------------------------------------------------------------------

def test_single_device_elastic_fit_equals_the_uninterrupted_run(tmp_path):
    """A resize to 1 device at step 2 (resident state stays put), a grow to 2
    at step 4 that one process cannot meet (skipped, no budget), a crash at
    step 5 restored onto the survivor: the final params, moments and carried
    ascent gradient equal the uninterrupted run's bit for bit."""
    cfg = get_config("olmo-1b", reduced=True)
    bundle = build_model(cfg)
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.25)

    def fit(events, sub):
        inner = FusedExecutor(bundle.loss_fn, mcfg, optim.adamw(1e-3),
                              mesh=make_host_mesh(device="cpu"), model_cfg=cfg)
        ex = ElasticExecutor(inner, model_cfg=cfg, resize_budget=2)
        pipe = TokenPipeline(cfg, PipelineConfig(global_batch=4, seq_len=16,
                                                 ascent_fraction=0.25, prefetch=0),
                             device="cpu")
        cb = CheckpointCallback(CheckpointManager(tmp_path / sub, keep=2),
                                ResilienceConfig(save_every=2))
        with Engine(ex, pipe, [cb]) as eng:
            state = ex.init_state(bundle.init(0, "cpu"), 1)
            return eng.fit(state, 8, events=events), ex

    clean, _ = fit(None, "clean")
    rep, ex = fit(ChaosSchedule([MeshEvent(2, 1), MeshEvent(4, 2),
                                 MeshEvent(5, 1, kind="crash")]), "chaos")
    assert rep.restarts == 1 and ex.resize_events == 2 and rep.steps_done == 8
    assert ex.inner.resident and ex.inner.mesh is None
    assert [m["mesh_devices"] for m in rep.metrics_history] == [1.0] * len(rep.metrics_history)
    a, b = clean.final_state, rep.final_state
    for x, y in ((a.params, b.params), (a.opt_state[0].mu, b.opt_state[0].mu),
                 (a.opt_state[0].nu, b.opt_state[0].nu),
                 (a.method_state.ascent_grad, b.method_state.ascent_grad)):
        assert all(torch.equal(p, q) for p, q in zip(x.buffers, y.buffers))


def test_device_loss_raises_through_a_non_resilient_fit():
    """Without a CheckpointCallback a crash event is the step's failure."""
    ex = _hetero_elastic()
    with Engine(ex, _batches(4)) as eng:
        state = ex.init_state(mlp_init(0, device="cpu"), 1)
        with pytest.raises(DeviceLoss, match="device loss at step 2"):
            eng.fit(state, 4, events=ChaosSchedule([MeshEvent(2, 1, kind="crash")]))


# ---------------------------------------------------------------------------
# launch.steps: the train-setup shim against the reference's
# ---------------------------------------------------------------------------

def test_train_setup_step_matches_the_reference():
    jcfg, cfg = jax_get_config("olmo-1b", reduced=True), get_config("olmo-1b", reduced=True)
    jbundle, bundle = jax_build_model(jcfg), build_model(cfg)
    jparams = jax.jit(jbundle.init)(jax.random.PRNGKey(0))
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    mkw = dict(name="async_sam", rho=0.05, ascent_fraction=0.25)
    jsetup = jax_make_train_setup(jbundle, JMethodConfig(**mkw), joptim.adamw(1e-3))
    setup = make_train_setup(bundle, MethodConfig(**mkw), optim.adamw(1e-3))
    jstate = jsetup.init_state(jparams, jax.random.PRNGKey(1))
    state = setup.init_state(model, 1)
    jstep = jax.jit(jsetup.step_fn)
    for i in range(3):
        jb = jax_synth_batch(jcfg, 8, 16, jax.random.PRNGKey(10 + i), 0.25)
        b = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jb)
        jstate, jm = jstep(jstate, jb)
        state, m = setup.step_fn(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-5)
    got = _flat(to_reference(state.params.to_tree(), leaf=lambda t: t.detach().numpy()))
    want = {}
    jax_tree_map_with_path(lambda p, x: want.__setitem__(p, np.asarray(x)), jstate.params)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=2e-5, err_msg=k)
    # the bridge to the engine, and the serve shims
    ex = setup.fused_executor()
    assert isinstance(ex, FusedExecutor) and ex.resident
    tokens = torch.zeros(2, 4, dtype=torch.int32)
    logits, _ = make_prefill_step(bundle)(model, {"tokens": tokens})
    assert logits.shape[0] == 2 and torch.isfinite(logits).all()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def test_decode_step_shim_runs():
    cfg = get_config("olmo-1b", reduced=True)
    bundle = build_model(cfg)
    model = bundle.init(0, "cpu")
    cache = bundle.init_cache(2, 16, device="cpu")
    logits, cache = make_decode_step(bundle)(model, cache,
                                             {"tokens": torch.zeros(2, 1, dtype=torch.int32)})
    assert logits.shape[0] == 2 and torch.isfinite(logits).all()
