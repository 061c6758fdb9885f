"""Virtual-clock online driver: trace-driven `ServiceScheduler` runs.

An offline run submits a fixed fleet of tasks and sweeps until quiet.
:class:`OnlineDriver` replays a
:class:`~repro_torch.core.workload.WorkloadTrace` against a live
:class:`~repro_torch.core.lifecycle.ServiceScheduler` on a **virtual clock**:

- tasks are submitted when their trace arrival time is reached (the
  template builds each :class:`TaskRequest` from its arrival index, so
  arms sharing a trace see identical traffic);
- a :class:`~repro_torch.core.lifecycle.RejectedTask` (``max_queue``
  backpressure) is **requeued from its own echo** — the rejection
  carries the request plus the queue depth, so the driver needs no
  side-channel bookkeeping — with exponential backoff
  (``backoff * 2**attempt``); no task is ever silently dropped
  (property-tested in tests/test_workload.py);
- the trace's diurnal availability wave is adapted onto the
  lifecycle's ``availability_fn`` seam, evaluated at the *virtual
  time* each period checkpoint actually happens;
- after every sweep the clock advances by the wall-clock of that
  sweep's simulated work: tenants run concurrently, so the sweep
  duration is the **max** over tenants of their chunk's summed
  ``round_latency`` metrics (``default_round_latency`` per round when
  the trainer carries no fault plan, ``idle_tick`` when the sweep did
  nothing but the service still waits);
- every observable action lands in a
  :class:`~repro_torch.core.telemetry.TelemetryLog` with virtual timestamps,
  and terminal tenants are retired so the pool of live tenants stays
  bounded no matter how long the trace runs.

With an empty trace (``initial_tasks`` only, no availability, no
plan), the driver performs *exactly* the submit-then-sweep sequence of
driving ``ServiceScheduler`` by hand — the no-trace path is
bit-identical to the offline scheduler (asserted in tests and in
benchmarks/bench_workload.py).
"""
from __future__ import annotations

import heapq

from .lifecycle import RejectedTask, ServiceScheduler
from .telemetry import TelemetryLog
from .workload import WorkloadTrace


class OnlineDriver:
    """Drive ``scheduler`` with ``trace``, return SLA telemetry.

    ``trainer_factory()`` builds one trainer per accepted task (the
    driver attaches ``trace.plan`` to it when the trainer exposes a
    ``fault_plan`` attribute and the factory left it unset, so traces
    carry device behaviour without the factory knowing). ``scheduler``
    is caller-built — backpressure (``max_queue``), the in-flight
    window and eviction deadlines are service configuration, not trace
    configuration.
    """

    def __init__(self, scheduler: ServiceScheduler, trace: WorkloadTrace,
                 trainer_factory, *, backoff: float = 1.0,
                 backoff_cap: float = 64.0,
                 default_round_latency: float = 1.0, idle_tick: float = 1.0,
                 max_sweeps: int = 100_000):
        self.scheduler = scheduler
        self.trace = trace
        self.trainer_factory = trainer_factory
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)   # max retry delay: keeps
        # repeated rejections from exploding the exponential into the
        # dominant completion-time term (the queue, not the backoff,
        # should set the SLA under saturation)
        self.default_round_latency = float(default_round_latency)
        self.idle_tick = float(idle_tick)
        self.max_sweeps = int(max_sweeps)
        self.telemetry = TelemetryLog()
        self.now = 0.0
        # task_index -> (tid, arrival_time) for accepted, live tenants
        self._live: dict[int, tuple[int, float]] = {}
        self.phases: dict[int, str] = {}      # task_index -> terminal phase
        self.results: dict[int, list] = {}    # task_index -> [RoundEvent]

    # -- internals -----------------------------------------------------------

    def _availability_fn(self):
        if self.trace.availability is None:
            return None
        return self.trace.availability.availability_fn(lambda: self.now)

    def _make_trainer(self):
        trainer = self.trainer_factory()
        if (self.trace.plan is not None
                and getattr(trainer, "fault_plan", None) is None
                and hasattr(trainer, "fault_plan")):
            trainer.fault_plan = self.trace.plan
        return trainer

    def _submit(self, index: int, task, arrival: float, attempt: int,
                retries: list) -> None:
        out = self.scheduler.submit(task, self._make_trainer(),
                                    availability_fn=self._availability_fn())
        if isinstance(out, RejectedTask):
            # requeue from the echo: out.task IS the request, out.queued
            # the backlog depth — nothing else needed to resubmit
            delay = min(self.backoff * (2.0 ** attempt), self.backoff_cap)
            self.telemetry.record("reject", self.now, index,
                                  queued=out.queued, reason=out.reason,
                                  attempt=attempt, retry_at=self.now + delay)
            heapq.heappush(retries,
                           (self.now + delay, index, attempt + 1, out.task))
        else:
            # device_of: placement fabric seam (core/placement.py) — which
            # mesh device the tenant's chunks dispatch on. 0 until the
            # scheduler's next sweep places the tenant.
            self.telemetry.record("accept", self.now, index, tid=int(out),
                                  attempt=attempt,
                                  device=self.scheduler.device_of(int(out)))
            self._live[index] = (int(out), arrival)

    def _sweep_duration(self, swept: dict) -> float:
        if not swept:
            return self.idle_tick
        per_tenant = [sum(e.metrics.get("round_latency",
                                        self.default_round_latency)
                          for e in evs)
                      for evs in swept.values() if evs]
        return max(per_tenant) if per_tenant else self.idle_tick

    # -- the loop ------------------------------------------------------------

    def run(self, initial_tasks: list | None = None) -> TelemetryLog:
        """Replay the trace to completion; returns the telemetry log.

        ``initial_tasks`` are submitted at time zero ahead of any trace
        arrival (the no-trace identity path uses only these).
        """
        arrivals: list[tuple[float, int, object]] = []
        for i, task in enumerate(initial_tasks or []):
            arrivals.append((0.0, i, task))
        base = len(arrivals)
        for j, t in enumerate(self.trace.arrivals.arrivals(
                self.trace.horizon)):
            task = self.trace.template(base + j, float(t))
            arrivals.append((float(t), base + j, task))
        arrivals.sort(key=lambda a: (a[0], a[1]))

        retries: list[tuple[float, int, int, object]] = []  # (due, idx, att, task)
        cursor = 0
        sweeps = 0
        while True:
            # 1) submit everything due at the current virtual time, in
            # time order across fresh arrivals and backoff retries
            while True:
                fresh_due = (cursor < len(arrivals)
                             and arrivals[cursor][0] <= self.now)
                retry_due = retries and retries[0][0] <= self.now
                if fresh_due and (not retry_due
                                  or arrivals[cursor][0] <= retries[0][0]):
                    t_arr, idx, task = arrivals[cursor]
                    cursor += 1
                    # observed now (>= t_arr when a long sweep jumped
                    # the clock past the arrival); queue-wait is
                    # measured from the trace arrival either way
                    self.telemetry.record("submit", self.now, idx,
                                          arrival=t_arr)
                    self._submit(idx, task, t_arr, 0, retries)
                elif retry_due:
                    _, idx, attempt, task = heapq.heappop(retries)
                    arrival = dict((e.task, e.data["arrival"])
                                   for e in self.telemetry.of_kind("submit")
                                   )[idx]
                    self._submit(idx, task, arrival, attempt, retries)
                else:
                    break

            pending = cursor < len(arrivals) or bool(retries)
            if not self.scheduler.active and not pending:
                break               # drained: all tasks terminal + retired
            if sweeps >= self.max_sweeps:
                break               # safety valve; telemetry still valid

            if self.scheduler.active:
                # 2) one sweep of real work, clock += its wall time
                swept = self.scheduler.sweep()
                sweeps += 1
                self.now += self._sweep_duration(swept)
                for tid, evs in swept.items():
                    index = self._tid_index(tid)
                    self.results.setdefault(index, []).extend(evs)
                    for e in evs:
                        self.telemetry.record_round(self.now, index, e)
                self._retire_terminal()
            else:
                # 3) idle service, future arrivals: jump to the next due
                nxt = min(([arrivals[cursor][0]]
                           if cursor < len(arrivals) else [])
                          + ([retries[0][0]] if retries else []))
                self.now = max(self.now, nxt)
        return self.telemetry

    def _tid_index(self, tid: int) -> int:
        for index, (t, _) in self._live.items():
            if t == tid:
                return index
        return -1

    def _retire_terminal(self) -> None:
        for index in list(self._live):
            tid, arrival = self._live[index]
            st = self.scheduler.state(tid)
            if st.phase.terminal:
                self.phases[index] = st.phase.name
                self.telemetry.record("done", self.now, index,
                                      tid=tid, phase=st.phase.name,
                                      periods=st.period,
                                      device=self.scheduler.device_of(tid))
                self.scheduler.retire(tid)
                del self._live[index]
