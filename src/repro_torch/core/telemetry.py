"""SLA telemetry for the online workload harness.

The online driver (:mod:`repro_torch.core.driver`) appends one
:class:`TelemetryEvent` per observable service action — task submitted,
submission rejected (backpressure), task accepted into INTAKE, round
completed, task reaching a terminal phase — all stamped with the
driver's virtual clock. :meth:`TelemetryLog.summary` folds the log into
the SLA aggregates the workload bench publishes
(``BENCH_service.json["workload"]``, field docs in docs/benchmarks.md):

- ``round_latency_p50`` / ``round_latency_p99`` — per-round simulated
  latency (the lifecycle's fault-mode ``metrics["round_latency"]``);
- ``queue_wait_p50`` / ``queue_wait_p99`` — trace arrival → accepted
  into INTAKE, i.e. time spent bouncing off ``max_queue`` backpressure
  plus retry backoff;
- ``completion_p50`` / ``completion_p99`` — trace arrival → terminal
  phase, the end-to-end task SLO;
- ``degraded_rate`` — fraction of finished tasks parked DEGRADED
  rather than DONE;
- ``jain_fairness`` — Jain's index over realized per-client round
  participation counts across all tasks (fairness under contention);
- plus counters: ``tasks_submitted`` / ``tasks_finished`` /
  ``rejects`` / ``rounds`` / ``makespan``.

The log is plain data (no service references), so benches can merge,
diff and JSON-serialize summaries freely.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from .fairness import jain_index


@dataclasses.dataclass(frozen=True)
class TelemetryEvent:
    """One driver-observed service action at virtual time ``time``.

    ``kind`` is one of ``submit`` / ``reject`` / ``accept`` / ``round``
    / ``done``; ``task`` is the driver's trace-arrival index (stable
    across rejects/requeues — the scheduler's tid only exists after
    acceptance and lives in ``data["tid"]``).
    """

    kind: str
    time: float
    task: int
    data: dict


class TelemetryLog:
    """Append-only event log + SLA aggregation."""

    def __init__(self) -> None:
        self.events: list[TelemetryEvent] = []
        # realized participation: client id -> rounds participated
        self.participation: Counter = Counter()

    # -- recording (called by the driver) -----------------------------------

    def record(self, kind: str, time: float, task: int, **data) -> None:
        self.events.append(TelemetryEvent(kind, float(time), int(task), data))

    def record_round(self, time: float, task: int, event) -> None:
        """Fold one lifecycle :class:`RoundEvent` in (participation +
        latency metrics when the fault path emitted them)."""
        for cid in event.subset:
            self.participation[int(cid)] += 1
        self.record("round", time, task,
                    period=event.period, round_index=event.round_index,
                    round_latency=event.metrics.get("round_latency"),
                    n_scheduled=event.metrics.get("n_scheduled"),
                    n_arrived=event.metrics.get("n_arrived"))

    # -- views ---------------------------------------------------------------

    def of_kind(self, kind: str) -> list[TelemetryEvent]:
        return [e for e in self.events if e.kind == kind]

    def round_latencies(self) -> np.ndarray:
        lat = [e.data["round_latency"] for e in self.of_kind("round")
               if e.data.get("round_latency") is not None]
        return np.asarray(lat, dtype=np.float64)

    def queue_waits(self) -> np.ndarray:
        """Arrival -> acceptance delay per accepted task."""
        arrived = {e.task: e.data["arrival"] for e in self.of_kind("submit")}
        return np.asarray([e.time - arrived[e.task]
                           for e in self.of_kind("accept")
                           if e.task in arrived], dtype=np.float64)

    def completions(self) -> np.ndarray:
        """Arrival -> terminal-phase delay per finished task."""
        arrived = {e.task: e.data["arrival"] for e in self.of_kind("submit")}
        return np.asarray([e.time - arrived[e.task]
                           for e in self.of_kind("done")
                           if e.task in arrived], dtype=np.float64)

    # -- aggregation ---------------------------------------------------------

    def summary(self) -> dict:
        """The SLA aggregate dict (all plain floats/ints, JSON-ready)."""
        done = self.of_kind("done")
        degraded = sum(1 for e in done if e.data.get("phase") == "DEGRADED")
        counts = np.asarray(sorted(self.participation.values()),
                            dtype=np.float64)
        out = {
            "tasks_submitted": len(self.of_kind("submit")),
            "tasks_finished": len(done),
            "rejects": len(self.of_kind("reject")),
            "rounds": len(self.of_kind("round")),
            "degraded_rate": round(degraded / max(len(done), 1), 4),
            "jain_fairness": (round(float(jain_index(counts)), 4)
                              if counts.size else 1.0),
            "makespan": round(max((e.time for e in self.events),
                                  default=0.0), 3),
        }
        for name, values in (("round_latency", self.round_latencies()),
                             ("queue_wait", self.queue_waits()),
                             ("completion", self.completions())):
            out[f"{name}_p50"] = _pct(values, 50)
            out[f"{name}_p99"] = _pct(values, 99)
        return out

    def format_summary(self) -> str:
        """Human-readable SLA table (the demo prints this)."""
        s = self.summary()
        rows = [("tasks (submitted/finished)",
                 f"{s['tasks_submitted']} / {s['tasks_finished']}"),
                ("backpressure rejects", str(s["rejects"])),
                ("rounds", str(s["rounds"])),
                ("round latency p50 / p99",
                 f"{s['round_latency_p50']} / {s['round_latency_p99']}"),
                ("queue wait p50 / p99",
                 f"{s['queue_wait_p50']} / {s['queue_wait_p99']}"),
                ("completion p50 / p99",
                 f"{s['completion_p50']} / {s['completion_p99']}"),
                ("DEGRADED rate", f"{s['degraded_rate']:.2%}"),
                ("Jain fairness (participation)",
                 f"{s['jain_fairness']:.4f}"),
                ("makespan (sim time)", str(s["makespan"]))]
        width = max(len(k) for k, _ in rows)
        return "\n".join(f"  {k.ljust(width)}  {v}" for k, v in rows)


def _pct(values: np.ndarray, q: float) -> float | None:
    if values.size == 0:
        return None
    return round(float(np.percentile(values, q)), 3)
