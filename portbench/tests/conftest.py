"""Shared fixtures of the benchmark's CPU tests: the repo root and the
port's sources on the path, and tiny versions of the cells."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(num_layers=2, d_model=128, num_heads=2, num_kv_heads=1,
            head_dim=64, d_ff=256, vocab_size=64)
TINY_TRAFFIC = {"fl_lora": dict(seq_len=16),
                "fedsgd": dict(seq_len=32, seqs_per_client=8),
                "prefill": dict(prompt_len=64, interval_ms=20,
                                check_batches=3)}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_spec(workload: str, dtype: str = "float32", limits=None):
    """The cell's spec at a CPU size: the model cut to 2 layers of width
    128, the traffic's lengths shortened, everything else as the cell
    has it (limits from ``limits/<cell>.json`` unless given)."""
    from portbench import harness
    spec = harness.Spec(bench(), workload)
    cfg = dict(spec.config, **TINY, dtype=dtype)
    traffic = dict(spec.traffic, **TINY_TRAFFIC[spec.traffic["driver"]])
    return harness.Spec(bench(), workload, configs=cfg, traffic=traffic,
                        limits=limits)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
