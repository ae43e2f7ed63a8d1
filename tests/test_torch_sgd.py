"""Port parity for the SGD slice: the plain versions of sgd_epilogue and
sam_perturb against the JAX package's Pallas kernels (interpret mode) and
jnp oracles; the per-leaf optimizer chain and the fused epilogue against
each other and against the reference's chain; fused, resident and per-leaf
training steps on olmo-1b-reduced against each other and against the JAX
package; masked weight decay; the launcher's `--optimizer sgd`.

Tolerances are the reference's own (tests/test_kernels.py): fp32 2e-5, bf16
2e-2. Every tensor here lies on the CPU; the Hopper kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core import MethodConfig as JMethodConfig
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.engine import Engine as JEngine
from repro.engine import FusedExecutor as JFusedExecutor
from repro.kernels import fused_update as jfu
from repro.kernels import ref as jref
from repro.kernels import sam_perturb as jsp
from repro.models import build_model as jax_build_model
from repro.utils import buckets as jbuckets
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig, init_train_state, make_method
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import Engine, FusedExecutor
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import buckets, trees

REPO = pathlib.Path(__file__).resolve().parents[1]
_DT = {"float32": (jnp.float32, torch.float32, np.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16)}
F32_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else F32_TOL


def _vec(n, dtype, seed, scale=1.0):
    """The same values for both frameworks, rounded to `dtype` once in numpy."""
    a = (np.random.default_rng(seed).standard_normal(n).astype(np.float32) * scale)
    a = a.astype(_DT[dtype][2])
    return jnp.asarray(a), torch.from_numpy(a.astype(np.float32)).to(_DT[dtype][1])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels and the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum,nesterov,wd", [(0.9, False, 0.0), (0.9, True, 1e-4),
                                                  (0.0, False, 5e-4)])
def test_sgd_epilogue_plain_matches_pallas_and_oracle(momentum, nesterov, wd, dtype,
                                                      n=200_001):
    jw, tw = _vec(n, dtype, 0)
    jg, tg = _vec(n, "float32", 1)
    jm, tm = _vec(n, "float32", 2)
    hyper = dict(momentum=momentum, nesterov=nesterov, weight_decay=wd)
    jm_in = jm if momentum else None
    kw, km = jax.jit(lambda w, g, m: jfu.sgd_epilogue(w, g, m, 0.7, 0.1, interpret=True,
                                                      **hyper))(jw, jg, jm_in)
    ow, om = jref.sgd_epilogue_flat_jnp(jw, jg, jm_in, 0.7, 0.1, **hyper)
    w, m = ref.sgd_epilogue_flat_plain(tw, tg, tm if momentum else None, 0.7, 0.1, **hyper)
    assert w.dtype == tw.dtype
    for e in (kw, ow):
        np.testing.assert_allclose(_np(w), _np(e), **_tol(dtype))
    if momentum:
        assert m.dtype == torch.float32
        for e in (km, om):
            np.testing.assert_allclose(_np(m), _np(e), **F32_TOL)
    else:
        assert m is None and km is None and om is None
    # ops updates w (and m) in place and returns them; no momentum leaves m be
    bw, bm = tw.clone(), tm.clone()
    out = ops.sgd_epilogue(bw, tg, bm, torch.tensor(0.7), torch.tensor(0.1), **hyper)
    assert out[0] is bw and (out[1] is bm if momentum else out[1] is None)
    torch.testing.assert_close(bw, w, rtol=0, atol=0)
    torch.testing.assert_close(bm, m if momentum else tm, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1000, 65536, 200_001])
def test_sam_perturb_plain_matches_pallas_and_oracle(n, dtype):
    jw, tw = _vec(n, dtype, 3)
    jg, tg = _vec(n, "float32", 4)
    sn = float(jsp.sq_norm(jg, interpret=True))
    kernel = jax.jit(lambda w, g: jsp.sam_perturb(w, g, 0.1, sn, interpret=True))(jw, jg)
    oracle = jref.sam_perturb_flat_jnp(jw.astype(jnp.float32), jg, jnp.float32(0.1),
                                       jnp.float32(sn)).astype(_DT[dtype][0])
    got = ops.sam_perturb(tw, tg, 0.1, torch.tensor(sn))
    assert got.dtype == tw.dtype and got.shape == (n,)
    for e in (kernel, oracle):
        np.testing.assert_allclose(_np(got), _np(e), **_tol(dtype))
    # the same arithmetic as the axpy with the reference's scale
    scale = ref.sam_perturb_scale(0.1, torch.tensor(sn), tw.device)
    torch.testing.assert_close(got, ref.axpy_flat_plain(scale, tg, tw), rtol=0, atol=0)
    out = torch.empty_like(tw)
    assert ops.sam_perturb(tw, tg, 0.1, sn, out=out) is out
    torch.testing.assert_close(out, got, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the optimizer: fused epilogue vs per-leaf chain vs the reference's chain
# (tests/test_fused_update.py's configurations)
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd_plain": lambda o: o.sgd(0.1),
    "sgd_full": lambda o: o.sgd(0.1, momentum=0.9, nesterov=True, weight_decay=1e-4,
                                clip_norm=1.0),
    "sgd_mom_wd": lambda o: o.sgd(o.cosine_schedule(0.1, 50), momentum=0.9,
                                  weight_decay=5e-4),
    "adamw": lambda o: o.adamw(0.01, clip_norm=0.5),
    "adamw_nowd": lambda o: o.adamw(0.01, weight_decay=0.0),
}
_SHAPES = {"w": (8, 4), "b": (4,), "z": (3, 5)}


def _tree(seed, dtype="float32", scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s).astype(np.float32) * scale).astype(_DT[dtype][2])
            for k, s in _SHAPES.items()}


def _torch_tree(t, dtype="float32"):
    return {k: torch.from_numpy(v.astype(np.float32)).to(_DT[dtype][1]) for k, v in t.items()}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_fused_apply_matches_per_leaf_chain_and_reference(name):
    params, grads = _tree(0), [_tree(10 + i) for i in range(4)]
    opt, jopt = OPTIMIZERS[name](optim), OPTIMIZERS[name](joptim)
    p1 = _torch_tree(params)
    st1 = opt.init(p1)
    p2 = buckets.BucketedState.from_tree(_torch_tree(params))
    st2 = opt.init(p2)
    p3 = _torch_tree(params)                       # per-leaf state, fused (gather/scatter)
    st3 = opt.init(p3)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp)
    for g in grads:
        upd, st1 = opt.update(_torch_tree(g), st1, p1)
        p1 = optim.apply_updates(p1, upd)
        _, st2, gnorm = optim.fused_apply(opt, buckets.BucketedState.from_tree(
            _torch_tree(g), p2.layout), st2, p2)
        leaves = dict(p3)
        out = optim.fused_apply(opt, _torch_tree(g), st3, p3)
        assert out[0] is p3 and all(p3[k] is leaves[k] for k in p3)     # written in place
        st3 = out[1]
        jupd, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = joptim.apply_updates(jp, jupd)
    for got in (p1, p2.to_tree(), p3):
        for k in _SHAPES:
            np.testing.assert_allclose(_np(got[k]), np.asarray(jp[k]), **F32_TOL, err_msg=k)
    for st in (st1, buckets.to_portable(st2), st3):
        assert [type(s).__name__ for s in st] == [type(s).__name__ for s in jst]
        assert trees.tree_paths(st) == [p for p in _jax_paths(jst)]
        for a, b in zip(trees.tree_leaves(st), jax.tree.leaves(jst)):
            np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), **F32_TOL)
    np.testing.assert_allclose(float(gnorm), float(np.sqrt(sum(
        (v.astype(np.float64) ** 2).sum() for v in grads[-1].values()))), rtol=1e-6)


def _jax_paths(tree):
    from repro.utils import trees as jtrees
    return jtrees.tree_paths(tree)


@pytest.mark.parametrize("name", ["sgd_full", "adamw"])
def test_fused_apply_matches_per_leaf_chain_with_bf16_params(name):
    """bf16 w: the kernel computes w - lr d in fp32 and rounds once; the chain
    computes apply_updates(w, -lr d) in fp32 and rounds once too."""
    opt = OPTIMIZERS[name](optim)
    p1 = _torch_tree(_tree(0, "bfloat16"), "bfloat16")
    p2 = buckets.BucketedState.from_tree({k: v.clone() for k, v in p1.items()})
    st1, st2 = opt.init(p1), opt.init(p2)
    for i in range(4):
        g = _torch_tree(_tree(10 + i, "bfloat16"), "bfloat16")
        upd, st1 = opt.update(g, st1, p1)
        p1 = optim.apply_updates(p1, upd)
        _, st2, _ = optim.fused_apply(opt, buckets.BucketedState.from_tree(g, p2.layout),
                                      st2, p2)
    assert p2.buffers[0].dtype == torch.bfloat16
    for k, v in p2.to_tree().items():
        assert p1[k].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(v), _np(p1[k]), **_tol("bfloat16"), err_msg=k)


def test_per_leaf_chain_order_and_masked_decay_match_reference():
    """sgd's chain is clip -> decay -> trace -> lr (decay enters the momentum);
    a decay mask sees the reference's leaf paths (tests/test_system.py)."""
    opt = optim.chain(optim.add_decayed_weights(0.1, mask_fn=lambda p: "scale" not in p),
                      optim.scale_by_learning_rate(1.0))
    params = {"w": torch.ones(2), "ln": {"scale": torch.ones(2)}}
    g = {"w": torch.zeros(2), "ln": {"scale": torch.zeros(2)}}
    u, _ = opt.update(g, opt.init(params), params)
    np.testing.assert_allclose(u["w"].numpy(), -0.1 * np.ones(2))
    np.testing.assert_allclose(u["ln"]["scale"].numpy(), np.zeros(2))
    # a port parameter name is matched by its reference path
    flat = {"blocks.0.ln.scale": torch.ones(2), "blocks.0.attn.wq": torch.ones(2)}
    u, _ = opt.update({k: torch.zeros(2) for k in flat}, opt.init(flat), flat)
    assert float(u["blocks.0.ln.scale"].abs().max()) == 0.0
    np.testing.assert_allclose(u["blocks.0.attn.wq"].numpy(), -0.1 * np.ones(2))
    assert trees.tree_paths(flat) == ["blocks/attn/wq", "blocks/ln/scale"]
    sgd = optim.sgd(0.1, momentum=0.9, nesterov=True, weight_decay=1e-4, clip_norm=1.0)
    state = sgd.init(flat)
    assert [type(s).__name__ for s in state] == ["ClipState", "tuple", "TraceState",
                                                 "ScaleByScheduleState"]
    assert optim.adamw(0.01, decay_mask=lambda p: True).fused_spec is None
    assert optim.identity().update(g, ())[0] is g


# ---------------------------------------------------------------------------
# training steps on olmo-1b-reduced: fused/resident, fused/per-leaf and
# per-leaf, against each other and the JAX package (meshless, per-leaf)
# ---------------------------------------------------------------------------

BATCH, SEQ, STEPS = 4, 32, 3
STEP_OPTIMIZERS = {
    "sgd": lambda o: o.sgd(0.05),
    "sgd_full": lambda o: o.sgd(0.05, momentum=0.9, nesterov=True, weight_decay=1e-4,
                                clip_norm=1.0),
    "adamw": lambda o: o.adamw(0.01, clip_norm=1.0),
}


@pytest.fixture(scope="module")
def reduced():
    jcfg, cfg = jax_get_config("olmo-1b", reduced=True), get_config("olmo-1b", reduced=True)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _model(cfg, sd):
    model = transformer.init_params(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(sd)
    return model


def _port_fit(cfg, sd, method, opt, **switches):
    ex = FusedExecutor(build_model(cfg).loss_fn,
                       MethodConfig(name=method, rho=0.05, ascent_fraction=0.25), opt,
                       **switches)
    model = _model(cfg, sd)
    state = ex.init_state(model, seed=1)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=BATCH, seq_len=SEQ, seed=0,
                                             ascent_fraction=0.25, prefetch=0), device="cpu")
    rep = Engine(ex, pipe).fit(state, STEPS)
    return ex, rep, model


def _jax_fit(jcfg, jparams, method, jopt):
    ex = JFusedExecutor(jax_build_model(jcfg).loss_fn,
                        JMethodConfig(name=method, rho=0.05, ascent_fraction=0.25), jopt,
                        mesh=None, fused_update=False, resident=False, donate=False)
    state = ex.init_state(jparams, jax.random.PRNGKey(1))
    pipe = JTokenPipeline(jcfg, JPipelineConfig(global_batch=BATCH, seq_len=SEQ, seed=0,
                                                ascent_fraction=0.25, prefetch=0))
    with JEngine(ex, pipe) as eng:
        return eng.fit(state, STEPS)


def _flat(tree) -> np.ndarray:
    """A per-leaf tree or a BucketedState as the reference's flat buffer."""
    if buckets.is_bucketed(tree):
        return tree.buffers[0].numpy()
    return buckets.BucketedState.from_tree(tree).buffers[0].numpy()


@pytest.mark.parametrize("method", ["sam", "async_sam"])
@pytest.mark.parametrize("opt_name", sorted(STEP_OPTIMIZERS))
def test_method_steps_fused_resident_per_leaf_and_reference_agree(reduced, method,
                                                                   opt_name):
    jcfg, cfg, jparams, sd = reduced
    runs = {}
    for label, switches in (("resident", {}), ("gathered", {"resident": False}),
                            ("per_leaf", {"fused_update": False})):
        ex, rep, model = _port_fit(cfg, sd, method, STEP_OPTIMIZERS[opt_name](optim),
                                   **switches)
        assert (ex.fused_update, ex.resident) == {
            "resident": (True, True), "gathered": (True, False),
            "per_leaf": (False, False)}[label]
        assert buckets.is_bucketed(rep.final_state.params) == ex.resident
        # the model reads what the steps wrote
        got = dict(model.named_parameters())
        for k, v in buckets.to_portable(rep.final_state.params).items():
            assert torch.equal(got[k].detach(), v), k
        runs[label] = rep
    jrep = _jax_fit(jcfg, jparams, method, STEP_OPTIMIZERS[opt_name](joptim))
    jst = jbuckets.to_portable(jrep.final_state)
    expect_w = np.asarray(jbuckets.BucketedState.from_tree(jst.params).buffers[0])
    for label, rep in runs.items():
        for m, jm in zip(rep.metrics_history, jrep.metrics_history):
            for k in ("loss", "grad_norm", "ascent_norm"):
                assert m[k] == pytest.approx(jm[k], rel=1e-4), (label, k)
        _hold_w(_flat(rep.final_state.params), expect_w, opt_name, label)
    # the resident and the per-leaf port paths: one framework, one order of
    # sums but the global norms'
    _hold_w(_flat(runs["per_leaf"].final_state.params),
            _flat(runs["resident"].final_state.params), opt_name, "per_leaf vs resident")
    if opt_name == "sgd_full":
        jm = np.asarray(jbuckets.BucketedState.from_tree(jst.opt_state[2].momentum
                                                         ).buffers[0])
        for label, rep in runs.items():
            np.testing.assert_allclose(_flat(rep.final_state.opt_state[2].momentum), jm,
                                       rtol=0, atol=2e-5 * np.abs(jm).max(), err_msg=label)


def _hold_w(w, expect, opt_name, label):
    """fp32 on both sides; the paths differ in the order of sums only. SGD
    moves each weight by lr times its gradient, so w stays within fp32 noise
    of max|w|; Adam normalizes each update, so a weight whose gradient sits
    at that noise may take its ~lr step the other way: the bulk is held to
    1e-4 of max|w| and every weight to 2 sum(lr), as in
    tests/test_torch_train.py and tests/test_torch_cuda.py."""
    diff, scale = np.abs(w - expect), np.abs(expect).max()
    if opt_name.startswith("sgd"):
        assert diff.max() <= 2e-5 * scale, (label, diff.max() / scale)
    else:
        assert np.quantile(diff, 0.999) <= 1e-4 * scale, label
        assert diff.max() <= 2 * 0.01 * STEPS, label


def test_adamw_decay_mask_trains_per_leaf_and_matches_reference(reduced):
    """adamw(decay_mask=...) has no FusedSpec: the executor resolves per-leaf
    state, as the reference's does, and the two agree."""
    jcfg, cfg, jparams, sd = reduced
    mask = lambda path: "embed" not in path                      # noqa: E731
    ex, rep, _ = _port_fit(cfg, sd, "async_sam",
                           optim.adamw(0.01, weight_decay=0.1, decay_mask=mask))
    assert (ex.fused_update, ex.resident) == (True, False)
    jrep = _jax_fit(jcfg, jparams, "async_sam",
                    joptim.adamw(0.01, weight_decay=0.1, decay_mask=mask))
    for m, jm in zip(rep.metrics_history, jrep.metrics_history):
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-4)
    expect = np.asarray(jbuckets.BucketedState.from_tree(jrep.final_state.params
                                                         ).buffers[0])
    diff = np.abs(_flat(rep.final_state.params) - expect)
    assert np.quantile(diff, 0.999) <= 1e-4 * np.abs(expect).max()
    with pytest.raises(ValueError, match="resident"):
        FusedExecutor(build_model(cfg).loss_fn, MethodConfig(),
                      optim.adamw(0.01, decay_mask=mask), resident=True)


@pytest.mark.parametrize("fused", [False, True])
def test_perturb_and_perturb_masked_match_reference(fused):
    """perturb / perturb_masked on per-leaf trees, fused (gathered into
    buckets: sq_norm + sam_perturb) and per-leaf, against the reference's."""
    from repro.core.perturb import perturb as jax_perturb
    from repro.core.perturb import perturb_masked as jax_perturb_masked
    from repro_torch.core import perturb, perturb_masked
    params, grad = _tree(0), _tree(1)
    mask = {k: (np.random.default_rng(2).random(v.shape) < 0.6).astype(np.float32)
            for k, v in params.items()}
    j = {name: jax.tree.map(jnp.asarray, t) for name, t in
         (("p", params), ("g", grad), ("m", mask))}
    t = {name: _torch_tree(tr) for name, tr in (("p", params), ("g", grad), ("m", mask))}
    out = {"full": perturb(t["p"], t["g"], 0.05, fused=fused),
           "masked": perturb_masked(t["p"], t["g"], 0.05, t["m"], fused=fused)}
    expect = {"full": jax_perturb(j["p"], j["g"], 0.05, fused=False),
              "masked": jax_perturb_masked(j["p"], j["g"], 0.05, j["m"], fused=False)}
    for kind in out:
        for k in _SHAPES:
            np.testing.assert_allclose(_np(out[kind][k]), np.asarray(expect[kind][k]),
                                       **F32_TOL, err_msg=(kind, k))
    delta = np.concatenate([(_np(out["masked"][k]) - params[k]).ravel() for k in _SHAPES])
    assert float(np.linalg.norm(delta)) == pytest.approx(0.05, rel=1e-5)


def test_method_config_per_leaf_is_accepted():
    method = make_method(MethodConfig(name="sam", fused_update=False))
    opt = optim.sgd(0.1, momentum=0.9)
    state = init_train_state({"w": torch.ones(3)}, opt, method, resident=False)
    step = method.make_step(lambda p, b, g: ((p["w"] ** 2).sum(), {}), opt)
    state, m = step(state, {})
    assert not buckets.is_bucketed(state.params) and state.step == 1
    # ||g|| = 2 sqrt(3); w_hat = w + 0.1 g/||g||; the update uses g at w_hat
    w_hat = 1.0 + 0.1 / np.sqrt(3.0)
    np.testing.assert_allclose(state.params["w"].numpy(), 1.0 - 0.1 * 2 * w_hat, rtol=1e-6)
    assert float(m["ascent_norm"]) == pytest.approx(2 * np.sqrt(3.0), rel=1e-6)


def test_train_cli_sgd_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--reduced",
         "--device", "cpu", "--method", "async_sam", "--optimizer", "sgd", "--lr", "0.5",
         "--steps", "6", "--batch", "4", "--seq", "32", "--log-every", "1",
         "--fused-update", "on", "--resident", "auto"],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    losses = [float(x) for x in re.findall(r"^step +\d+ +\{'loss': '([0-9.]+)'",
                                            proc.stdout, re.M)]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert "sgd_epilogue" in proc.stdout.splitlines()[-2]
