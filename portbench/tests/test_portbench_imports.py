"""Nothing the benchmark runs imports JAX or the JAX package: module
names are compared whole at the top level (the port's ``repro_torch``
begins with the JAX package's ``repro``)."""
import ast
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


RUN = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
import torch
from conftest import tiny_spec
from portbench import harness, control, faults
from portbench.drivers import fl_lora, fedsgd, prefill
for w in ("prefill.smollm-360m", "fl_lora.smollm-360m", "fedsgd.smollm-360m"):
    harness.run(tiny_spec(w), 7, 0.2, False, device="cpu")
for f in harness.PKG.joinpath("metrics").glob("[!_]*.py"):
    harness.metric_reader(f.name[:-3])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = RUN.format(src=str(ROOT / "src"), root=str(ROOT),
                      tests=str(ROOT / "portbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
