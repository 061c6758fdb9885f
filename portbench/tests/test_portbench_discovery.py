"""A configuration, a traffic mix, a per-layer metric and a cell are
added as files and entries alone, and the harness finds them by name."""
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, TINY

RUN = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import harness
bench = json.load(open({bench!r}))
spec = harness.Spec(bench, "prefill.tiny-dense")
assert spec.config["name"] == "tiny-dense" and spec.traffic["batch"] == 2
assert [m["name"] for m in spec.per_layer] == ["prompt_count.tiny"]
assert [m["name"] for m in spec.end_to_end] == ["ttft_p95_ms", "setup_s"]
r = harness.run(spec, 3, 0.2, False, device="cpu")
ctx = harness.Context(None, None, 17, 0, {{}}, {{}})
print(json.dumps([r["correct"], harness.metric_reader("prompt_count.tiny")(ctx)]))
"""


def test_new_files_are_found_by_name(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", tmp_path / "src")
    cfg = json.loads((pb / "configs" / "smollm-360m.json").read_text())
    cfg.update(TINY, name="tiny-dense", dtype="float32")
    (pb / "configs" / "tiny-dense.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "prefill_16x2048.json").read_text())
    mix.update(batch=2, prompt_len=16, interval_ms=10, check_batches=2)
    (pb / "traffic" / "tiny_prefill.json").write_text(json.dumps(mix))
    (pb / "metrics" / "prompt_count.tiny.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    (pb / "limits" / "prefill.tiny-dense.json").write_text(
        json.dumps({"served_logit_gap": 1e-4}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense", "source": "test",
                             "file": "portbench/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "prefill.tiny-dense",
                               "config": "tiny-dense",
                               "traffic": "tiny_prefill", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "ttft_p95_ms":
            m["workloads"].append("prefill.tiny-dense")
    bench["per_layer"].append({"name": "prompt_count.tiny", "unit": "prompts",
                               "better": "higher", "source": "program_counter",
                               "layer": "serve entry", "moves": "ttft_p95_ms",
                               "workloads": ["prefill.tiny-dense"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = RUN.format(root=str(tmp_path), src=str(tmp_path / "src"),
                      bench=str(tmp_path / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, 17.0]
