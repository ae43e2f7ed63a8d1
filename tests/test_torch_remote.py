"""Port parity for Form B: the lossy compressors and the staleness ledger,
the heterogeneous executor against the JAX package's, the remote executor
against the port's own heterogeneous one, the int8 delta stream on a live
server, clients and servers of the two packages against each other, and
both lane launchers on the CPU.

Tolerances, per test: the compressors and the ledger are exact (the same
IEEE operations in the same order); the hetero trajectory is held to
tests/test_torch_train.py's (1e-4 relative on the scalars, the bulk of the
weights to 1e-4 of their max); remote against hetero in the port is
lockstep-deterministic, to rtol 1e-6 as tests/test_service.py pins it for
the reference; a gradient across the packages to the reference's gradient
tolerance (rtol 2e-4, atol 2e-6: the order of sums differs); a lossy
exchange by its direction (cosine > 0.99).
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core import Compressor as JCompressor
from repro.core import MethodConfig as JMethodConfig
from repro.core import StalenessLedger as JStalenessLedger
from repro.core import slice_ascent_batch as jslice_ascent_batch
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.data.synthetic import ClassificationTask
from repro.engine import Engine as JEngine
from repro.engine import HeteroExecutor as JHeteroExecutor
from repro.engine import RemoteExecutor as JRemoteExecutor
from repro.models import build_model as jax_build_model
from repro.runtime import ExecutorConfig as JExecutorConfig
from repro.service import ascent_server as jserver
from repro.service.testing import mlp_init as jmlp_init
from repro.service.testing import mlp_loss as jmlp_loss
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import Compressor, MethodConfig, StalenessLedger, make_ascent_fn
from repro_torch.core.api import key_generator
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import Engine, HeteroExecutor, RemoteExecutor
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_jax, to_reference
from repro_torch.runtime import ExecutorConfig
from repro_torch.runtime.async_executor import place_tree
from repro_torch.service import protocol
from repro_torch.service.ascent_server import AscentServer, spawn_server
from repro_torch.service.client import RemoteAscentClient
from repro_torch.service.testing import MLP_LOSS_SPEC, mlp_loss
from repro_torch.utils import buckets

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the compressors and the ledger: exact
# ---------------------------------------------------------------------------

def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((50, 7)).astype(np.float32),
            "nested": {"b": rng.standard_normal(33).astype(np.float32)}}


@pytest.mark.parametrize("kind,frac", [("int8", 0.01), ("topk", 0.1)])
def test_compressor_with_error_feedback_matches_reference(kind, frac):
    comp, jcomp = Compressor(kind, frac), JCompressor(kind, frac)
    state = comp.init({"w": torch.zeros(50, 7), "nested": {"b": torch.zeros(33)}})
    jstate = jcomp.init(_grad_tree(0))
    for seed in range(3):
        g = _grad_tree(seed)
        out, state = comp.compress(place_tree(g, "cpu"), state)
        jout, jstate = jcomp.compress(jax.tree.map(jax.numpy.asarray, g), jstate)
        for a, b in zip(buckets.host_flatten(out)[0], jax.tree.leaves(jout)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(buckets.host_flatten(state.error)[0], jax.tree.leaves(jstate.error)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert comp.wire_bytes(g) == jcomp.wire_bytes(g)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_form_a_carries_the_compressed_ascent_gradient_as_the_reference(kind):
    """Form A with a lossy compressor carries Q(a + e) and its residual, as
    the reference's step does: 4 AsyncSAM steps on L(w) = 0.5 w'Aw, the
    weights, the carried gradient and the residual to 1e-5 (fp32, the same
    operations; the quantizer's inputs agree to rounding)."""
    import jax.numpy as jnp

    from repro.core import init_train_state as jinit_train_state
    from repro.core import make_method as jmake_method
    from repro_torch.core import init_train_state, make_method

    rng = np.random.default_rng(0)
    m = rng.standard_normal((6, 6))
    A = (m @ m.T / 6 + np.eye(6)).astype(np.float32)
    w0 = np.arange(1.0, 7.0, dtype=np.float32)
    kw = dict(name="async_sam", rho=0.1, ascent_fraction=1.0, compressor=kind,
              topk_fraction=0.5)
    method, jmethod = make_method(MethodConfig(**kw)), jmake_method(JMethodConfig(**kw))
    opt, jopt = optim.sgd(0.05), joptim.sgd(0.05)
    state = init_train_state({"w": torch.from_numpy(w0.copy())}, opt, method)
    jstate = jinit_train_state({"w": jnp.asarray(w0)}, jopt, jmethod, jax.random.PRNGKey(0))
    step = method.make_step(lambda p, b, g: (0.5 * p["w"] @ b["A"] @ p["w"], {}), opt)
    jstep = jax.jit(jmethod.make_step(lambda p, b, r: (0.5 * p["w"] @ b["A"] @ p["w"], {}),
                                      jopt))
    for _ in range(4):
        state, _ = step(state, {"A": torch.from_numpy(A)})
        jstate, _ = jstep(jstate, {"A": jnp.asarray(A)})
        ms, jms = state.method_state, jstate.method_state
        for got, want in ((state.params, jstate.params), (ms.ascent_grad, jms.ascent_grad),
                          (ms.compression.error, jms.compression.error)):
            np.testing.assert_allclose(buckets.host_flatten(_portable(got))[0][0].numpy(),
                                       np.asarray(jax.tree.leaves(want)[0]),
                                       rtol=1e-5, atol=1e-6)


def _portable(tree):
    return tree.to_tree() if buckets.is_bucketed(tree) else tree


def test_staleness_ledger_matches_reference():
    led, jled = StalenessLedger(max_staleness=2), JStalenessLedger(max_staleness=2)
    for op in ["fresh", "reuse", "reuse", "reuse", "fresh", "reuse", "reuse", "reuse"]:
        if op == "fresh":
            led.on_fresh()
            jled.on_fresh()
        else:
            assert led.on_reuse() == jled.on_reuse()
        assert led.summary() == jled.summary()
    assert (led.stale_reuses, led.sgd_fallbacks, led.refreshes) == (2, 4, 2)


# ---------------------------------------------------------------------------
# the heterogeneous executor against the reference's (olmo-1b-reduced)
# ---------------------------------------------------------------------------

BATCH, SEQ, FRAC, STEPS = 8, 32, 0.25, 6
TRAJ_RTOL, TRAJ_BULK, TRAJ_MAX = 1e-4, 1e-4, 1e-3      # tests/test_torch_train.py's


@pytest.fixture(scope="module")
def reduced():
    jcfg, cfg = jax_get_config("olmo-1b", reduced=True), get_config("olmo-1b", reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _model(cfg, sd):
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(sd)
    return model


def _pipe(cfg, cls=TokenPipeline, pcls=PipelineConfig, **kw):
    return cls(cfg, pcls(global_batch=BATCH, seq_len=SEQ, seed=0, ascent_fraction=FRAC,
                         prefetch=0), **kw)


def test_hetero_lockstep_matches_reference(reduced):
    """SGD with momentum (the paper's optimizer), 6 lockstep steps: step 0
    unperturbed, tau = 1 after, the trajectory within test_torch_train.py's
    tolerance."""
    jcfg, cfg, jparams, sd = reduced
    mkw = dict(name="async_sam", rho=0.05, ascent_fraction=FRAC)
    ex = HeteroExecutor(build_model(cfg).loss_fn, MethodConfig(**mkw),
                        optim.sgd(optim.cosine_schedule(0.05, STEPS), momentum=0.9),
                        exec_cfg=ExecutorConfig(lockstep=True))
    with Engine(ex, _pipe(cfg, device="cpu")) as eng:
        rep = eng.fit(ex.init_state(_model(cfg, sd), seed=1), STEPS)
    jex = JHeteroExecutor(jax_build_model(jcfg).loss_fn, JMethodConfig(**mkw),
                          joptim.sgd(joptim.cosine_schedule(0.05, STEPS), momentum=0.9),
                          exec_cfg=JExecutorConfig(lockstep=True, fused_update=True))
    with JEngine(jex, _pipe(jcfg, JTokenPipeline, JPipelineConfig)) as eng:
        jrep = eng.fit(jex.init_state(jparams, jax.random.PRNGKey(1)), STEPS)
    assert ex.resident and jex._inner.resident
    for i, (m, jm) in enumerate(zip(rep.metrics_history, jrep.metrics_history)):
        assert m["tau"] == jm["tau"] == (0.0 if i == 0 else 1.0), i
        assert m["perturbed"] == jm["perturbed"], i
        for k in ("loss", "grad_norm", "ascent_norm"):
            assert m[k] == pytest.approx(jm[k], rel=TRAJ_RTOL, abs=1e-7), (i, k, m[k], jm[k])
    got = rep.final_state.params.buffers[0].numpy()
    expect = np.asarray(jrep.final_state.params.buffers[0])
    diff, scale = np.abs(got - expect), np.abs(expect).max()
    assert np.quantile(diff, 0.999) <= TRAJ_BULK * scale
    assert diff.max() <= TRAJ_MAX * scale


# ---------------------------------------------------------------------------
# the remote lane (the port's server and client, the MLP of service.testing)
# ---------------------------------------------------------------------------

TASK = ClassificationTask(n_classes=4, dim=8, seed=3)


def _mlp_batches(n, frac=0.5):
    out = []
    for b in TASK.train_batches(64, n):
        b = {**b, "ascent": jslice_ascent_batch(b, frac)}
        out.append(b)
    return out


def _torch_batch(b):
    return {k: _torch_batch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in b.items()}


def _mlp_params(seed=0):
    p = jax.device_get(jmlp_init(jax.random.PRNGKey(seed), (8, 32, 4)))
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p.items()}


def _fit_port(ex, steps=8):
    with ex:
        state = ex.init_state(_mlp_params(), seed=1)
        return Engine(ex, [_torch_batch(b) for b in _mlp_batches(steps)]).fit(state, steps)


def test_remote_matches_hetero_step_for_step():
    """Loopback remote (full snapshots) == hetero, lockstep: the same taus,
    the same losses (tests/test_service.py's pin for the reference)."""
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5)
    rep_h = _fit_port(HeteroExecutor(mlp_loss, mcfg, optim.sgd(0.1, momentum=0.9),
                                     exec_cfg=ExecutorConfig(lockstep=True)))
    rep_r = _fit_port(RemoteExecutor(
        mlp_loss, mcfg, optim.sgd(0.1, momentum=0.9),
        exec_cfg=ExecutorConfig(lockstep=True, serve_ascent=True, loss_spec=MLP_LOSS_SPEC,
                                descent_device="cpu")))
    taus_h = [m["tau"] for m in rep_h.metrics_history]
    assert taus_h == [m["tau"] for m in rep_r.metrics_history] == [0.0] + [1.0] * 7
    np.testing.assert_allclose([m["loss"] for m in rep_r.metrics_history],
                               [m["loss"] for m in rep_h.metrics_history], rtol=1e-6, atol=1e-7)
    last = rep_r.metrics_history[-1]
    assert last["job_bytes"] + last["grad_bytes"] == last["wire_bytes"] and last["rtt_s"] > 0
    assert "wire_bytes" not in rep_h.metrics_history[-1]


def _cosine(a, b):
    la, lb = buckets.host_flatten(a)[0], buckets.host_flatten(b)[0]
    dot = sum(float(np.sum(x * np.asarray(y))) for x, y in zip(la, lb))
    na = np.sqrt(sum(float(np.sum(np.square(x))) for x in la))
    nb = np.sqrt(sum(float(np.sum(np.square(np.asarray(y)))) for y in lb))
    return dot / (na * nb + 1e-12)


@pytest.mark.parametrize("encoding", ["int8", "topk"])
def test_delta_exchange_tracks_true_gradient(encoding):
    """Delta-encoded JOBs: the server computes on its shadow, so the gradient
    tracks the true-params gradient (cosine > 0.99); the measured JOB frames
    equal the length model for both job kinds; int8's params direction is
    >= 4x smaller than a snapshot's."""
    server = AscentServer(mlp_loss, device="cpu")
    server.serve_in_thread()
    client = RemoteAscentClient(server.address, Compressor("none"), job_encoding=encoding,
                                job_delta=True, job_topk_fraction=0.2)
    ascent = make_ascent_fn(mlp_loss)
    try:
        params = _mlp_params()
        batch = _torch_batch(_mlp_batches(1)[0]["ascent"])
        key = np.array([0, 5], np.uint32)
        rs = np.random.RandomState(0)
        for step in range(4):
            assert client.submit(0, params, batch, key, step)
            got = client.poll(block=True, timeout=120.0)
            assert got is not None and got[1] is not None
            _, g, _, meta = got
            assert meta["job_bytes"] + meta["grad_bytes"] == meta["wire_bytes"]
            g_true, _, _ = ascent(to_reference(params), batch, key_generator(key, "cpu"))
            assert _cosine(g, {k: v.numpy() for k, v in g_true.items()}) > 0.99
            params = {k: v + 0.01 * torch.from_numpy(rs.randn(*v.shape).astype(np.float32))
                      for k, v in params.items()}
        host = buckets.host_portable(params)
        hb = {k: v.numpy() for k, v in batch.items()}
        assert client.job_frame_measured["snapshot"] == protocol.job_frame_bytes(
            encoding, host, hb, key, delta=False)
        assert client.job_frame_measured[encoding] == protocol.job_frame_bytes(
            encoding, host, hb, key, delta=True, topk_fraction=0.2)
        assert client.job_encoder.delta_jobs == 3 and client.job_encoder.encode_failures == 0
        if encoding == "int8":
            snap = protocol.job_frame_breakdown(encoding, host, hb, key, delta=False)
            dlt = protocol.job_frame_breakdown(encoding, host, hb, key, delta=True)
            assert snap["params"] >= 4.0 * dlt["params"]
        assert server.deltas_applied == 3
    finally:
        client.close()
        server.close()


def test_receiving_leaves_the_senders_socket_timeout_alone():
    """A pool's handler thread polls for the next JOB on the socket its
    worker thread sends the GRAD on. The reference's poll sets the socket's
    timeout to 0.2 s, which a `sendall` starting right after takes for the
    whole frame: a 2 GB GRAD then times out and the client is dropped. The
    port's poll leaves the timeout as the sender set it."""
    import socket
    import threading

    a, b = socket.socketpair()
    try:
        a.settimeout(120.0)
        stop = threading.Event()
        errors = []

        def poll():
            try:
                protocol.recv_exact(a, 16, stop=stop)
            except ConnectionAbortedError:
                pass
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        reader = threading.Thread(target=poll)
        reader.start()
        time.sleep(0.5)                  # the reader has polled a few times
        assert a.gettimeout() == 120.0
        stop.set()
        reader.join(timeout=5.0)
        assert not reader.is_alive() and not errors
        b.sendall(b"x" * 16)             # a frame still arrives whole
        assert protocol.recv_exact(a, 16) == b"x" * 16
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_port_client_against_reference_server(reduced):
    """The port's client drives `python -m repro.service.ascent_server
    --loss arch:olmo-1b:reduced`: a snapshot, then an int8 delta. Each GRAD
    is the port's own ascent gradient at the params the server holds (the
    true params, then the client's shadow, which the server's equals bit
    for bit)."""
    _, cfg, _, sd = reduced
    state = buckets.BucketedState.from_module(_model(cfg, sd))
    pipe = _pipe(cfg, device="cpu")
    batch = pipe.peek()["ascent"]
    key = np.array([3, 1], np.uint32)
    ascent = make_ascent_fn(build_model(cfg).loss_fn)
    server = jserver.spawn_server("arch:olmo-1b:reduced")
    client = RemoteAscentClient(server.addr, Compressor("none"), job_encoding="int8")
    try:
        for step in range(2):
            assert client.submit(0, state, batch, key, step)
            got = client.poll(block=True, timeout=240.0)
            assert got is not None and got[1] is not None, client.last_error
            _, g, norm, _ = got
            held = buckets.host_portable(state) if step == 0 else buckets.host_unflatten(
                buckets.host_layout(buckets.host_portable(state)).treedef,
                _cut(client.job_encoder.shadow_host(), state))
            g_port, n_port, _ = ascent(place_tree(held, "cpu"), batch, key_generator(key, "cpu"))
            assert norm == pytest.approx(float(n_port), rel=2e-4)
            for a, b in zip(buckets.host_flatten(g)[0], buckets.host_flatten(g_port)[0]):
                np.testing.assert_allclose(a, b.numpy(), rtol=2e-4, atol=2e-6)
            with torch.no_grad():
                state.buffers[0].mul_(1.001)
        assert client.last_job_kind == "int8" and client.job_encoder.delta_jobs == 1
    finally:
        client.close()
        server.kill()
    assert server.stats()["deltas_applied"] == 1


def _cut(bufs, state):
    """The leaves of `state`'s wire tree, cut from host bucket buffers."""
    layout = buckets.host_layout(buckets.host_portable(state))
    return buckets.host_flatten(buckets.host_buckets_to_tree(bufs, layout))[0]


def test_reference_client_against_port_server():
    """The reference's RemoteExecutor against `python -m
    repro_torch.service.ascent_server --loss repro_torch.service.testing:
    mlp_loss` matches the reference's hetero run step for step (the ascent
    gradients come from torch: the order of sums differs)."""
    mcfg = JMethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5)

    def fit(ex, steps=8):
        with ex:
            state = ex.init_state(jmlp_init(jax.random.PRNGKey(0), (8, 32, 4)),
                                  jax.random.PRNGKey(1))
            return JEngine(ex, _mlp_batches(steps)).fit(state, steps)

    server = spawn_server(MLP_LOSS_SPEC, device="cpu")
    try:
        rep_r = fit(JRemoteExecutor(jmlp_loss, mcfg, joptim.sgd(0.1, momentum=0.9),
                                    exec_cfg=JExecutorConfig(lockstep=True,
                                                             ascent_addr=server.addr)))
    finally:
        server.kill()
    rep_h = fit(JHeteroExecutor(jmlp_loss, mcfg, joptim.sgd(0.1, momentum=0.9),
                                exec_cfg=JExecutorConfig(lockstep=True)))
    assert [m["tau"] for m in rep_r.metrics_history] == [m["tau"] for m in rep_h.metrics_history]
    np.testing.assert_allclose([m["loss"] for m in rep_r.metrics_history],
                               [m["loss"] for m in rep_h.metrics_history], rtol=1e-5, atol=1e-6)
    # the 7 harvested exchanges; the 8th may still be in flight at the close
    assert server.stats()["exchanges"] >= 7


# ---------------------------------------------------------------------------
# the lane launchers on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [["--executor", "hetero", "--calibrate"],
                                   ["--executor", "remote", "--serve-ascent",
                                    "--job-compress", "int8"]],
                         ids=["hetero", "remote-int8"])
def test_lane_launchers_run_on_cpu(extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--reduced",
         "--device", "cpu", "--method", "async_sam", "--steps", "12", "--batch", "4",
         "--seq", "32", "--log-every", "4", *extra],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert re.search(r"^staleness: \{'tau_hist'", out, re.M)
    launches = json.loads(re.search(r"^kernel launches: (.*)$", out, re.M).group(1))
    assert ("delta_amax" in launches) == (extra[1] == "remote")
    assert set(launches.values()) == {0}        # the plain versions on the CPU
    if "--calibrate" in extra:
        assert re.search(r"^calibration: configured b'/b=0\.250  system-aware b'/b=", out, re.M)
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["executor"] == extra[1] and summary["steps"] == 12
