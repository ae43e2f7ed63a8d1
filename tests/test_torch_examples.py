"""The port's examples (`repro_torch.examples`) on the CPU at a small size:
each `main()` runs to completion with `--device cpu`. Where the reference's
example (`examples/`) runs at the same small size, the final loss is held
against it on the same initial weights (the reference's, copied leaf by
leaf) and the same batches: quickstart's AsyncSAM run and hetero_async_sam's
synchronous SGD and SAM runs, at 1e-4 relative (`test_torch_train.py`'s
trajectory bound: fp32 on both sides, the sums' order differs). The
two-lane runs are free-running, so their schedule depends on timing; they
are held to finite results. Each module also runs as `python -m`.
"""
import dataclasses
import importlib.util
import math
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.core import MethodConfig as JMethodConfig
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.engine import Engine as JEngine
from repro.engine import FusedExecutor as JFusedExecutor
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.examples import (hetero_async_sam, quickstart, remote_ascent, serve_batched,
                                  train_100m)
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
STEPS = 6
HETERO = dict(steps=STEPS, batch=64, widths=(64, 48, 48, 10))


def _reference_example(name: str):
    """The reference's `examples/<name>.py` as a module (it is not a
    package)."""
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_the_reference(monkeypatch):
    """quickstart's AsyncSAM run, STEPS steps of its schedule, from the
    reference's init: the reference's final loss."""
    jcfg = jget_config("olmo-1b", reduced=True)
    jbundle = jbuild_model(jcfg)
    sd = params_from_jax(jax.device_get(jbundle.init(jax.random.PRNGKey(0))))
    # the reference's quickstart, STEPS steps (its own runs 200)
    ex = JFusedExecutor(jbundle.loss_fn, JMethodConfig(name="async_sam", rho=0.05,
                                                       ascent_fraction=0.25),
                        joptim.adamw(joptim.cosine_schedule(3e-3, STEPS)))
    state = ex.init_state(jbundle.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))
    pipe = JTokenPipeline(jcfg, JPipelineConfig(global_batch=8, seq_len=64,
                                                ascent_fraction=0.25))
    with JEngine(ex, pipe) as eng:
        want = float(eng.fit(state, steps=STEPS).metrics_history[-1]["loss"])

    build = quickstart.build_model

    def from_reference(cfg):
        bundle = build(cfg)

        def init(seed=0, device="cuda"):
            m = transformer.init_params(cfg, device="meta").to_empty(device=device)
            m.load_state_dict(sd)
            return m

        return dataclasses.replace(bundle, init=init)

    monkeypatch.setattr(quickstart, "build_model", from_reference)
    got = quickstart.main(["--device", "cpu"], steps=STEPS)
    assert got["steps"] == STEPS and got["wall_s"] > 0
    assert got["final_loss"] == pytest.approx(want, rel=LOSS_RTOL)


def _reference_sync_loss(jh, method: str) -> float:
    """The reference example's `run_sync(method)` at HETERO's size; its final
    loss (the example reports time and accuracy)."""
    mcfg = JMethodConfig(name=method, rho=0.05, ascent_fraction=1.0, same_batch_ascent=True)
    ex = JFusedExecutor(jh.mlp_loss, mcfg, joptim.sgd(0.05, momentum=0.9), donate=False)
    state = ex.init_state(jh.mlp_init(jax.random.PRNGKey(0), HETERO["widths"]),
                          jax.random.PRNGKey(1))
    batches = list(jh.TASK.train_batches(HETERO["batch"], STEPS))
    with JEngine(ex, batches) as eng:
        return float(eng.fit(state, STEPS, warmup=1).metrics_history[-1]["loss"])


def test_hetero_async_sam_matches_the_reference(monkeypatch):
    """The synchronous SGD and SAM baselines from the reference's init: the
    reference's final losses; the two-lane runs (ascent lane on the CPU)
    finish with finite numbers."""
    jh = _reference_example("hetero_async_sam")
    want = {m: _reference_sync_loss(jh, m) for m in ("sgd", "sam")}
    init = {k: torch.from_numpy(np.array(v)) for k, v in
            jax.device_get(jh.mlp_init(jax.random.PRNGKey(0), HETERO["widths"])).items()}
    monkeypatch.setattr(hetero_async_sam, "mlp_init",
                        lambda seed, widths, device: {k: v.clone().to(device)
                                                      for k, v in init.items()})
    got = hetero_async_sam.main(["--device", "cpu"], **HETERO)
    for m in ("sgd", "sam"):
        assert got[m]["final_loss"] == pytest.approx(want[m], rel=LOSS_RTOL), m
    for run in ("async_sam_2x", "async_sam_4x"):
        r = got[run]
        assert math.isfinite(r["final_loss"]) and 0.0 <= r["acc"] <= 1.0, r
        assert r["ledger"]["tau"] >= 0


def test_remote_ascent_runs_and_keeps_lockstep_parity():
    """The loopback server (a subprocess on the CPU): the lockstep remote
    run's losses are the hetero run's; the free-running int8 run ends
    finite; the snapshot JOB frame is under the wire's bound."""
    got = remote_ascent.main(["--device", "cpu"], steps=4, async_steps=6, batch=64,
                             widths=(64, 32, 10))
    assert got["parity_max_loss_diff"] == 0.0
    assert len(got["remote_losses"]) == 4
    assert math.isfinite(got["final_loss"])
    assert 0 < got["snapshot_frame_bytes"] < 1 << 31


def test_remote_ascent_refuses_a_snapshot_past_the_frame_bound():
    """Reference fault 6's bound: a snapshot JOB over 2 GiB cannot be sent,
    so the example checks its model first (the count from shapes alone)."""
    assert remote_ascent.snapshot_frame_bytes((64, 1 << 14, 1 << 14, 10), 64) < 1 << 31
    wide = (64, 1 << 15, 1 << 14, 10)     # 2^29 fp32 weights: 2 GiB
    with pytest.raises(ValueError, match="frame bound"):
        remote_ascent.snapshot_frame_bytes(wide, 64)


def test_serve_batched_calls_the_ports_launcher():
    res = serve_batched.main(["--device", "cpu", "--requests", "2", "--max-new", "4"])
    assert tuple(res.tokens.shape) == (2, 4)
    assert torch.isfinite(res.logits).all()


def test_train_100m_trains_and_checkpoints(tmp_path):
    cfg = dataclasses.replace(train_100m.CFG_100M, n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16)
    got = train_100m.main(["--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16",
                           "--ckpt-dir", str(tmp_path)], cfg=cfg)
    assert got["steps"] == 4 and got["restarts"] == 0
    assert math.isfinite(got["final_loss"])
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == "step_00000004"


def test_train_100m_full_is_qwen3_8b_at_its_widths(monkeypatch):
    """--full takes qwen3-8b's published widths at FULL_LAYERS layers; here
    only the config it builds is checked (the run stops there, nothing of
    the model allocated)."""
    seen = {}

    def stop(cfg):
        seen["cfg"] = cfg
        raise SystemExit(0)

    monkeypatch.setattr(train_100m, "build_model", stop)
    with pytest.raises(SystemExit):
        train_100m.main(["--device", "cpu", "--full"])
    want = dataclasses.replace(get_config("qwen3-8b"), n_layers=train_100m.FULL_LAYERS)
    assert seen["cfg"] == want


@pytest.mark.parametrize("name", ["quickstart", "hetero_async_sam", "remote_ascent",
                                  "serve_batched", "train_100m"])
def test_examples_run_as_modules(name):
    """`python -m repro_torch.examples.<name>`: serve_batched serves at a
    small size on the CPU; each of the others (its run at the default size
    takes minutes on a CPU), asked for the card by default where there is
    none, exits non-zero after parsing its flags, without falling back to
    the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", f"repro_torch.examples.{name}"]
    if name == "serve_batched":
        proc = subprocess.run(cmd + ["--device", "cpu", "--requests", "2", "--max-new", "4"],
                              capture_output=True, text=True, timeout=120, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "decode : 3 steps" in proc.stdout
        return
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr[-3000:]
