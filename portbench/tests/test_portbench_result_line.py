"""The shape of a run's result line, and the runs that must print none."""
import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, tiny_spec
from portbench import harness

HEAD = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["prefill.smollm-360m",
                                      "fl_lora.smollm-360m",
                                      "fedsgd.smollm-360m"])
def test_result_keys_and_order(workload):
    r = json.loads(json.dumps(harness.run(tiny_spec(workload), 2**31 + 5,
                                          0.2, False, device="cpu")))
    keys = list(r)
    assert keys[:5] == HEAD and keys[-1] == "checks"
    assert isinstance(r["correct"], bool)
    assert r["attempted"] >= 1 and r["failed"] == 0
    spec = harness.Spec(harness.load_json(ROOT / "BENCHMARK.json"), workload)
    assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "prefill.smollm-360m", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=900)


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(ROOT)
    assert out.returncode != 0 and _no_result(out)


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and _no_result(out)


@pytest.mark.cuda
def test_run_on_the_card(cuda_device):
    out = _run_py(ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(r)[:5] == HEAD and r["device"]["platform"] == "gpu"
    assert r["correct"] is True
