"""The training launcher's distributed flags on the CPU: `torchrun` with 4
gloo ranks trains sharded through scripted resizes to `done: 12 steps`, and
each elastic flag check gives the reference launcher's error text."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_torchrun_elastic_launcher_on_four_cpu_ranks(tmp_path):
    """(2, 2) mesh of 4 ranks, resized to 2 at step 4 and back to 4 at step
    8, checkpointing every 4 steps: rank 0 alone prints, and the run is
    done."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--reduced", "--device", "cpu",
         "--executor", "fused", "--model-axis", "2", "--elastic", "--chaos", "4:2,8:4",
         "--steps", "12", "--batch", "8", "--seq", "16", "--log-every", "1",
         "--ckpt-dir", str(tmp_path / "ck"), "--save-every", "4"],
        capture_output=True, text=True, timeout=150, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    out = proc.stdout
    assert out.count("done: 12 steps, 0 restarts") == 1, out
    devices = [float(x) for x in re.findall(r"'mesh_devices': '([0-9.]+)'", out)]
    assert devices == [4.0] * 4 + [2.0] * 4 + [4.0] * 4, devices
    assert len(re.findall(r"'resize_events'", out)) == 2
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_00000004", "step_00000008", "step_00000012"]


@pytest.mark.parametrize("args", [
    ("--chaos", "40:4"),
    ("--elastic", "--chaos", "40:4,80:2:crash"),
    ("--executor", "hetero", "--model-axis", "2"),
], ids=["chaos-needs-elastic", "crash-needs-ckpt", "model-axis-fused-only"])
def test_elastic_flag_checks_match_the_reference(args, monkeypatch, capsys):
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    base = ["train", "--arch", "olmo-1b", "--reduced", "--steps", "1"]
    errors = []
    for main in (jtrain.main, train.main):
        monkeypatch.setattr("sys.argv", base + list(args))
        with pytest.raises(SystemExit) as e:
            main()
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] and "error:" in errors[0], errors
