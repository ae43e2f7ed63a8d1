"""Elastic training on a world of 8 CPU ranks (gloo): the port's
`ElasticExecutor` around a sharded `FusedExecutor`, the reference's
acceptance runs (tests/test_elastic.py) on the port.

* shrink -> grow -> shrink through scripted MeshEvents equals the
  uninterrupted run (the global batch is kept; only the per-rank slice moves);
* a crash-kind event restores the last checkpoint onto the survivors and
  equals the clean run;
* a checkpoint written on 8 ranks restores into a live 4-rank fit and into a
  1-device bucket-resident fit.
The ranks run as in tests/test_torch_distributed.py (`spawn_ranks`).
"""
import math

from test_torch_distributed import spawn_ranks

_COMMON = '''
import numpy as np
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import CheckpointCallback, ElasticExecutor, Engine, FusedExecutor
from repro_torch.models import build_model
from repro_torch.runtime import (ChaosSchedule, InjectedFailure, MeshEvent, ResilienceConfig,
                                 make_sized_mesh, state_shardings)
from repro_torch.utils import buckets, distributed

cfg = get_config("olmo-1b", reduced=True)
bundle = build_model(cfg)
mcfg = MethodConfig(name="async_sam", rho=0.02, ascent_fraction=0.5)


def pipe():
    return TokenPipeline(cfg, PipelineConfig(global_batch=8, seq_len=16, ascent_fraction=0.5,
                                             prefetch=0), device="cpu")


def fused(devices):
    return FusedExecutor(bundle.loss_fn, mcfg, optim.adamw(1e-3),
                         mesh=make_sized_mesh(devices), model_cfg=cfg)


def full_params(state):
    return {k: distributed.gather(v).numpy() for k, v in state.params.items()}


def holders(state):
    """The ranks whose shards of the params are not empty."""
    mine = all(v.to_local().numel() > 0 for v in state.params.values())
    got = [None] * distributed.world_size()
    torch.distributed.all_gather_object(got, mine)
    return [r for r, m in enumerate(got) if m]
'''

_SHRINK_GROW = _COMMON + '''
STEPS = 18


def run(rank, world, tmp):
    def fit(events):
        ex = ElasticExecutor(fused(8), model_cfg=cfg)
        with Engine(ex, pipe()) as eng:
            state = ex.init_state(bundle.init(0, "cpu"), 1)
            rep = eng.fit(state, STEPS, events=events)
        return rep, ex

    base, _ = fit(None)
    sched = ChaosSchedule([MeshEvent(5, 4), MeshEvent(10, 8), MeshEvent(15, 2)])
    chaos, ex = fit(sched)
    return {"steps": (base.steps_done, chaos.steps_done), "resize_events": ex.resize_events,
            "base_losses": [m["loss"] for m in base.metrics_history],
            "chaos_losses": [m["loss"] for m in chaos.metrics_history],
            "markers": [m["mesh_devices"] for m in chaos.metrics_history
                        if "resize_events" in m],
            "devices": [m["mesh_devices"] for m in chaos.metrics_history],
            "base": full_params(base.final_state), "chaos": full_params(chaos.final_state),
            "holders": holders(chaos.final_state)}
'''


def _close(a, b):
    import numpy as np
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


def test_chaos_shrink_grow_shrink_matches_uninterrupted(tmp_path):
    """18 AdamW AsyncSAM steps on make_sized_mesh(8), resized to 4 at step
    5, 8 at 10 and 2 at 15: the losses and final params equal the
    uninterrupted run's (rtol 2e-5, atol 1e-6), the markers are [4, 8, 2],
    the shards end on 2 ranks, and every rank reports the same numbers."""
    ranks = spawn_ranks(tmp_path, _SHRINK_GROW)
    r0 = ranks[0]
    assert r0["steps"] == (18, 18) and r0["resize_events"] == 3
    assert r0["markers"] == [4.0, 8.0, 2.0]
    assert r0["devices"] == [8.0] * 5 + [4.0] * 5 + [8.0] * 5 + [2.0] * 3
    assert all(math.isfinite(x) for x in r0["chaos_losses"])
    _close(r0["chaos_losses"], r0["base_losses"])
    for k in r0["base"]:
        _close(r0["chaos"][k], r0["base"][k])
    assert r0["holders"] == [0, 1]
    for r in ranks[1:]:
        assert r["chaos_losses"] == r0["chaos_losses"] and r["markers"] == r0["markers"]


_CRASH = _COMMON + '''
STEPS = 16


def run(rank, world, tmp):
    def fit(events, sub):
        ex = ElasticExecutor(fused(8), model_cfg=cfg)
        cb = CheckpointCallback(CheckpointManager(f"{tmp}/{sub}", keep=3),
                                ResilienceConfig(save_every=5, async_save=False))
        with Engine(ex, pipe(), [cb]) as eng:
            state = ex.init_state(bundle.init(0, "cpu"), 1)
            rep = eng.fit(state, STEPS, events=events)
        return rep, ex

    clean, _ = fit(None, "clean")
    rep, ex = fit(ChaosSchedule([MeshEvent(8, 4, kind="crash")]), "chaos")
    return {"restarts": rep.restarts, "resize_events": ex.resize_events,
            "steps": (clean.steps_done, rep.steps_done),
            "clean": full_params(clean.final_state), "chaos": full_params(rep.final_state),
            "holders": holders(rep.final_state),
            "losses": [m["loss"] for m in rep.metrics_history]}
'''


def test_crash_event_restores_onto_survivors(tmp_path):
    """A crash-kind event at step 8 to 4 ranks: one restart, the last
    checkpoint (step 5) restored and re-placed onto the 4 survivors, the
    replayed steps run there, and the final params equal the clean run's."""
    ranks = spawn_ranks(tmp_path, _CRASH)
    r0 = ranks[0]
    assert r0["restarts"] == 1 and r0["resize_events"] == 1
    assert r0["steps"] == (16, 16)
    assert r0["holders"] == [0, 1, 2, 3]
    for k in r0["clean"]:
        _close(r0["chaos"][k], r0["clean"][k])
    for r in ranks[1:]:
        assert r["losses"] == r0["losses"]


_INTEROP = _COMMON + '''
def run(rank, world, tmp):
    # phase A: an 8-rank fit, checkpointing
    mgr_a = CheckpointManager(f"{tmp}/a", keep=3)
    ex8 = fused(8)
    with Engine(ex8, pipe(), [CheckpointCallback(
            mgr_a, ResilienceConfig(save_every=4, async_save=False))]) as eng:
        rep_a = eng.fit(ex8.init_state(bundle.init(0, "cpu"), 1), 8)
    out = {"a_steps": rep_a.steps_done}

    # phase B: that checkpoint restored into a live 4-rank fit
    ex4 = fused(4)
    template = ex4.init_state(bundle.init(0, "cpu"), 1)
    sh4 = state_shardings(template, cfg, ex4.mesh)
    restored, extras = mgr_a.restore(template, shardings=sh4)
    pipe_b = pipe()
    pipe_b.restore(extras["pipeline"])
    crashed = []

    def inject(step):
        if step == 11 and not crashed:
            crashed.append(step)
            raise InjectedFailure("node loss on the 4-rank mesh")

    cb = CheckpointCallback(CheckpointManager(f"{tmp}/b", keep=3),
                            ResilienceConfig(save_every=3, async_save=False), shardings=sh4)
    with Engine(ex4, pipe_b, [cb]) as eng:
        rep_b = eng.fit(restored, 14, failure_injector=inject)
    out.update(b_start=int(restored.step), b_steps=rep_b.steps_done,
               b_restarts=rep_b.restarts, b_holders=holders(rep_b.final_state),
               b_loss=rep_b.metrics_history[-1]["loss"])

    # phase C: the same checkpoint into a 1-device bucket-resident fit
    if rank == 0:
        exr = FusedExecutor(bundle.loss_fn, mcfg, optim.adamw(1e-3), fused_update=True,
                            resident=True)
        template_r = exr.init_state(bundle.init(0, "cpu"), 1)
        restored_r, extras_r = mgr_a.restore(buckets.to_portable(template_r))
        state_r = buckets.residentize(restored_r, like=template_r)
        pipe_c = pipe()
        pipe_c.restore(extras_r["pipeline"])
        crashed_r = []

        def inject_r(step):
            if step == 10 and not crashed_r:
                crashed_r.append(step)
                raise InjectedFailure("node loss mid-resident-fit")

        cb_r = CheckpointCallback(CheckpointManager(f"{tmp}/c", keep=3),
                                  ResilienceConfig(save_every=3, async_save=False))
        with Engine(exr, pipe_c, [cb_r]) as eng:
            rep_c = eng.fit(state_r, 13, failure_injector=inject_r)
        out.update(c_start=int(state_r.step), c_steps=rep_c.steps_done,
                   c_restarts=rep_c.restarts, c_resident=buckets.is_resident(rep_c.final_state),
                   c_loss=rep_c.metrics_history[-1]["loss"])
    distributed.barrier()
    return out
'''


def test_ckpt_8_ranks_restores_into_4_rank_and_resident_fits(tmp_path):
    """A checkpoint of an 8-rank fit (step 8) restores into a live 4-rank
    fit, which survives an injected failure with its CheckpointCallback's
    shardings, and into a 1-device bucket-resident fit, which survives one
    too."""
    ranks = spawn_ranks(tmp_path, _INTEROP)
    r0 = ranks[0]
    assert r0["a_steps"] == 8 and r0["b_start"] == 8
    assert r0["b_steps"] == 14 and r0["b_restarts"] == 1
    assert r0["b_holders"] == [0, 1, 2, 3]
    assert math.isfinite(r0["b_loss"])
    assert r0["c_start"] == 8 and r0["c_steps"] == 13 and r0["c_restarts"] == 1
    assert r0["c_resident"] and math.isfinite(r0["c_loss"])
    assert all(r["b_loss"] == r0["b_loss"] for r in ranks)
