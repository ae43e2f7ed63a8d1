"""The port's serving entry point on the CPU, and its import isolation."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import TokenTask
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import resolve_device, serve
from repro_torch.models import build_model, transformer

REPO = pathlib.Path(__file__).resolve().parents[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_serve_cli_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "olmo-1b", "--reduced",
         "--device", "cpu", "--requests", "2", "--prompt-len", "12", "--max-new", "4"],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "prefill: 2x12 tok" in proc.stdout
    assert "decode : 3 steps" in proc.stdout
    assert "flash_attention kernel launches: 0" in proc.stdout


def test_serve_greedy_matches_full_forward():
    """prefill + stepwise decode == one full forward over the same tokens
    (the check of tests/test_serving.py, on the port, fp32)."""
    cfg = get_config("olmo-1b", reduced=True)
    model = build_model(cfg).init(seed=0, device="cpu")
    prompts = TokenTask(cfg.vocab_size, seed=0).sample(2, 12)
    res = serve(cfg, model, prompts, max_new=5)
    assert res.tokens.shape == (2, 5) and res.logits.shape == (2, 5, cfg.vocab_size)
    assert res.launches == {"flash_attention": 0}
    torch.testing.assert_close(res.tokens, res.logits.argmax(dim=-1), rtol=0, atol=0)
    full_tokens = torch.cat([torch.from_numpy(prompts).long(), res.tokens[:, :-1]], dim=1)
    with torch.inference_mode():
        full, _ = transformer.forward(model, {"tokens": full_tokens}, cfg)
    scale = float(full.abs().max())
    err = float((res.logits - full[:, 11:]).abs().max())
    assert err / scale < 3e-3, err


def test_serve_temperature_sampling_is_seeded():
    cfg = get_config("olmo-1b", reduced=True)
    model = build_model(cfg).init(seed=1, device="cpu")
    prompts = np.zeros((3, 4), np.int32)
    a = serve(cfg, model, prompts, 6, temperature=1.0, seed=3)
    b = serve(cfg, model, prompts, 6, temperature=1.0, seed=3)
    torch.testing.assert_close(a.tokens, b.tokens, rtol=0, atol=0)
    assert int(a.tokens.max()) < cfg.vocab_size
    with pytest.raises(ValueError):
        serve(cfg, model, prompts, 0)


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "olmo-1b", "--reduced",
                                      "--requests", "1", "--prompt-len", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main()                       # no --device: the default is cuda


def test_port_imports_no_jax_and_nothing_of_repro():
    code = """
import pkgutil, importlib, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "jaxlib.", "repro.")))
assert not bad, bad
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 43


def test_port_sources_name_no_jax_import():
    banned = re.compile(r"(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    for path in (REPO / "src" / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not banned.match(line.strip()), (path, line)
