"""One run of one cell: read the cell from ``BENCHMARK.json``, its
configuration from ``configs/<config>.json``, its traffic from
``traffic/<mix>.json`` and its limits from ``limits/<cell>.json``; build
the cell's driver (``drivers/<driver>.py``, named by the traffic file),
time its set-up, measure its window (traced with ``--trace 1``), check
its outputs against the plain reference, and print the result line.

Nothing here names a cell, a configuration, a mix or a metric: a later
change adds them as files and entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """A cell's entry, configuration, traffic, limits and metrics."""

    def __init__(self, bench: dict, workload: str, configs=None,
                 traffic=None, limits=None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: "
                             f"{sorted(cells)}")
        self.cell = cells[workload]
        self.name = workload
        self.chips = self.cell["chips"]
        conf = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.config = configs or load_json(ROOT / conf["file"])
        self.traffic = traffic or load_json(
            PKG / "traffic" / f"{self.cell['traffic']}.json")
        lim = PKG / "limits" / f"{workload}.json"
        self.limits = limits if limits is not None else (
            load_json(lim) if lim.exists() else {})
        self.run_seconds = bench["run_seconds"]
        reported = lambda m: "workloads" not in m or workload in m["workloads"]
        self.end_to_end = [m for m in bench["end_to_end"] if reported(m)]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in names)]


def driver_class(spec: Spec):
    mod = importlib.import_module(f"portbench.drivers.{spec.traffic['driver']}")
    return mod.Driver


def metric_reader(name: str):
    path = PKG / "metrics" / f"{name}.py"
    ms = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(ms)
    ms.loader.exec_module(mod)
    return mod.read


class Context:
    """What a per-layer reader reads: ``spans`` (yardstick.spans.Spans),
    ``trace`` (yardstick.trace.DeviceTrace), ``units`` (rounds, steps or
    requests completed in the traced window), ``flops`` (the model
    operations of that work), ``launches`` (the program's
    ``kernels.ops.LAUNCHES`` counted over the window) and ``costs``
    (kernel op -> (operations, bytes, peak operations/s) of one call)."""

    def __init__(self, spans, trace, units, flops, launches, costs):
        self.spans, self.trace, self.units = spans, trace, units
        self.flops, self.launches, self.costs = flops, launches, costs


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def has_chips(chips: int) -> bool:
    import torch
    return torch.cuda.is_available() and torch.cuda.device_count() >= chips


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def judge(checks: list, limits: dict) -> tuple[bool, dict]:
    """checks: [(name, value)]. Every value must be finite and at most
    its limit; a number without a limit fails."""
    out, ok = {}, True
    for name, value in checks:
        limit = limits.get(name)
        good = finite(value) and limit is not None and value <= limit
        ok &= good
        out[name] = {"value": value, "limit": limit}
    return ok and bool(checks), out


def run(spec: Spec, seed: int, seconds: float, trace: bool, device=None,
        t_start: float | None = None) -> dict:
    """One run; returns the result dict (``device=None`` is the card,
    after the look for it; a test passes ``"cpu"``)."""
    import torch
    from .yardstick.spans import Spans
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device("cuda" if device is None else device)
    spans = Spans()
    drv = driver_class(spec)(spec, seed % (1 << 63), dev, spans, seconds)
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    dtrace = None
    if trace:
        from .yardstick.trace import DeviceTrace
        dtrace = DeviceTrace()
        spans.on = True
        dtrace.start()
    win = drv.window(seconds)
    if dtrace is not None:
        dtrace.stop()
        spans.on = False
    launches = {k: ops.LAUNCHES[k] - before.get(k, 0) for k in ops.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    drv.release()
    t_check = time.perf_counter()
    checks = drv.check()
    check_s = time.perf_counter() - t_check
    correct, compared = judge(checks, spec.limits)
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"]}
    if trace:
        ctx = Context(spans, dtrace, win["units"], win["flops"], launches,
                      drv.costs())
        metrics = {}
        for m in spec.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end if m["name"] in values}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                        "kind": torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu",
                        "count": spec.chips, "memory_peak_bytes": peak}
    if trace:
        result["device"].update(busy_s=dtrace.busy_s,
                                window_s=dtrace.window_s)
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": dtrace.idle_by_span(spans)}
    result["notes"] = dict(win.get("notes", {}), check_s=check_s,
                           setup_phases_s=getattr(drv, "setup_phases_s", {}))
    result["checks"] = compared
    return result
