"""The correctness check's control and faults, at the reduced presets' size
on the CPU, against each cell's own limits: the program passes; the
reference computed with fp8 products in the program's place fails; and a
run driven with its timed path broken underneath comes out not correct,
once for each fault the cell can have (one card: no exchange between
chips to leave out; AsyncSAM's perturbation dropped where the cell runs
it)."""
from __future__ import annotations

import pytest
import torch

from bench import harness
from bench.kinds import prefill, train
from bench.reference import models, precision

TRAIN = [w["name"] for w in harness.benchmark()["workloads"]
         if harness.cell_files(w["name"], harness.benchmark())[2]["kind"] == "train"]
PERTURBED = [w for w in TRAIN if "rho" in harness.cell_files(w, harness.benchmark())[2]["method"]]
PREFILL = [w["name"] for w in harness.benchmark()["workloads"] if w["name"] not in TRAIN]


def ok(checks) -> bool:
    return all(c.ok for c in checks)


@pytest.mark.parametrize("workload", TRAIN)
def test_train_control_fails_where_the_program_passes(workload, small_ctx):
    ctx = small_ctx(workload)
    engine, _, _, prog = train.build(ctx, harness.port_config(ctx.cfg))
    engine.close()
    ref = train.reference(ctx)
    assert ok(harness.train_checks(prog, ref, ctx.limits))
    low = train.reference(ctx, mm=precision.fp8_mm)
    assert not ok(harness.train_checks(low, ref, ctx.limits))


def _unchanged(state, optimizer, grads, method_state, metrics, guard=False):
    """A step that returns its state unchanged but for the step count."""
    return state._replace(step=state.step + 1, method_state=method_state), dict(metrics)


def _half_loss(original):
    def loss_fn(self, params, batch, gen=None):
        n = batch["tokens"].shape[0]
        return original(self, params, {k: v[: max(1, n // 2)] for k, v in batch.items()}, gen)
    return loss_fn


def _unperturbed(w, a, rho, **kw):
    """A perturbation that leaves the weights where they are."""
    return w


@pytest.mark.parametrize("workload,fault", [(w, f) for w in TRAIN
                                            for f in ("state_unchanged", "half_batch")]
                         + [(w, "no_perturbation") for w in PERTURBED])
def test_train_run_with_a_fault_is_not_correct(workload, fault, small_ctx, monkeypatch):
    from repro_torch.core import async_sam, sam
    from repro_torch.models import registry
    if fault == "state_unchanged":
        monkeypatch.setattr(async_sam, "_finish", _unchanged)
        monkeypatch.setattr(sam, "_finish", _unchanged)
    elif fault == "no_perturbation":
        monkeypatch.setattr(async_sam, "perturb", _unperturbed)
    else:
        monkeypatch.setattr(registry.ModelBundle, "loss_fn",
                            _half_loss(registry.ModelBundle.loss_fn))
    ctx = small_ctx(workload)
    out = train.run(ctx)
    assert not ok(out.checks)


def _wider_ctx(small_ctx, workload, monkeypatch):
    """The prefill cell at a depth and width where a low-precision product
    moves the logits about as at full size (16 layers of d 512, vocabulary
    16384): in the reduced preset's two flat layers it barely does."""
    import dataclasses

    from repro_torch.configs import get_config
    wide = dataclasses.replace(get_config("olmo-1b", reduced=True), d_model=512, n_layers=16,
                               n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=16384)
    monkeypatch.setattr(harness, "port_config", lambda cfg: wide)
    ctx = small_ctx(workload)
    ctx.cfg = {**ctx.cfg, **dataclasses.asdict(wide)}
    ctx.traffic = {**ctx.traffic, "token_budget": 512, "lengths": [128], "per_cycle": [1],
                   "check_per_length": 32, "ref_tokens": 512}
    return ctx


@pytest.mark.parametrize("workload", PREFILL)
def test_prefill_control_fails_where_the_program_passes(workload, small_ctx, monkeypatch):
    ctx = _wider_ctx(small_ctx, workload, monkeypatch)
    from repro_torch.launch.serve import serve
    port = harness.port_config(ctx.cfg)
    model = prefill.build(ctx, port)
    seqs = prefill.schedule(ctx.seed, ctx.traffic, 20)     # a fixed amount of work
    served = [serve(port, model, prefill.prompts(ctx.seed, ctx.traffic, i, s, port.vocab_size,
                                                 ctx.device), 1).tokens[:, 0]
              for i, s in enumerate(seqs)]
    picked = prefill.sample(ctx.seed, ctx.traffic, seqs)
    served = torch.stack([served[i][r] for i, r in picked])
    got = prefill.reference_logits(ctx, seqs, picked,
                                   {"fp32": models.fp32_mm, "fp8": precision.fp8_mm})
    limit = ctx.limits["logit_gap"]
    assert harness.Check("logit_gap", prefill.widest_gap(got["fp32"], served), limit).ok
    control = prefill.widest_gap(got["fp32"], got["fp8"].argmax(dim=1))
    assert not harness.Check("logit_gap", control, limit).ok


@pytest.mark.parametrize("workload", PREFILL)
def test_prefill_run_with_an_altered_token_is_not_correct(workload, small_ctx, monkeypatch):
    from repro_torch.launch import serve
    ctx = small_ctx(workload)
    assert ok(prefill.run(ctx).checks)
    monkeypatch.setattr(serve, "_pick", lambda logits, t, g: logits.argmin(dim=-1)[:, None])
    assert not ok(prefill.run(ctx).checks)
