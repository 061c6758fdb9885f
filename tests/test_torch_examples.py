"""The port's examples run to their end on the CPU
(``--device cpu``), at their smallest sizes, as a user runs them."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_example(name, *args):
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), *args,
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_quickstart():
    out = run_example("quickstart_torch.py")
    assert "Stage 1: selected" in out and "bounded=True" in out
    assert "FL training on cpu: 24 rounds" in out


@pytest.mark.parametrize("plane", ["host", "device"])
def test_train_noniid(plane):
    out = run_example("train_noniid_torch.py", "--clients", "12",
                      "--rounds", "3", "--data-plane", plane)
    assert "[mkp   ] final acc" in out and "[random] final acc" in out
    assert "scheduling gain (mnist/type1)" in out


def test_fl_service_demo_resumes_the_lm_task():
    out = run_example("fl_service_demo_torch.py")
    assert "resumed from task_state.ckpt" in out
    assert "rounds equal: True, adapters equal: True" in out
    assert "ServiceScheduler served 4 concurrent tasks" in out


def test_serve_decode():
    out = run_example("serve_decode_torch.py")
    for arch in ("smollm-360m", "hymba-1.5b", "xlstm-125m",
                 "whisper-large-v3"):
        assert f"arch={arch}-reduced device=cpu prefill(2x24)" in out
    assert out.count("generated:") == 4
