"""Port parity for the online harness: ``repro_torch.core.workload``
(arrival traces, diurnal availability, device-speed profiles, the
heterogeneous fault plan, the named regimes), ``core.driver``
(``OnlineDriver``) and ``core.telemetry``, against the JAX package's.

All of it is host-side numpy, copied: every draw, trace, phase,
round event and telemetry record is held equal, bit for bit, with the
same stub trainers as the reference's tests/test_workload.py.
"""
import numpy as np
import pytest

import repro.core as R
from repro.core.driver import OnlineDriver as ROnlineDriver
from repro.core.telemetry import TelemetryLog as RTelemetryLog
from repro.core.workload import make_workload as r_make_workload
from repro_torch.core import (ArrivalTrace, DeviceSpeedProfile,
                              DiurnalAvailability, FaultPlan, FLServiceProvider,
                              HeterogeneousFaultPlan, OnlineDriver,
                              ServiceScheduler, TaskRequest, TelemetryLog,
                              WorkloadTrace, make_workload)
from repro_torch.core.pool import ClientPoolState

REGIMES = ("light", "saturating", "bursty", "steady", "diurnal")


def _round_result(rnd, subset):
    subset = np.asarray(subset)
    returned = (subset + rnd) % 7 != 0
    q = np.where(returned, 0.5 + 0.4 * np.cos(subset + rnd), 0.0)
    return returned, q, {"round": rnd}


class ChunkStub:
    accepts_arrivals = True

    def __init__(self, fault_plan=None):
        self.fault_plan = fault_plan

    def run_rounds(self, start_round, subsets, weights, arrivals=None):
        return [_round_result(start_round + j, s)
                for j, s in enumerate(subsets)]


@pytest.mark.parametrize("kw", [
    dict(seed=3, rate=0.7, window=8.0, burst_rate=4.0, burst_prob=0.3),
    dict(seed=0, rate=1.5, window=2.0), dict(seed=5, rate=0.0)])
def test_arrival_traces_bit_identical(kw):
    a, b = ArrivalTrace(**kw), R.ArrivalTrace(**kw)
    w = np.arange(40)
    for name in ("is_burst", "window_rate", "counts"):
        np.testing.assert_array_equal(getattr(a, name)(w),
                                      getattr(b, name)(w), err_msg=name)
    for t_end in (0.0, 17.5, 96.0, 400.0):
        np.testing.assert_array_equal(a.arrivals(t_end), b.arrivals(t_end))
    for win in (0, 3, 11):
        np.testing.assert_array_equal(a.window_arrivals(win),
                                      b.window_arrivals(win))


def test_availability_and_speed_bit_identical():
    kw = dict(seed=9, base=0.7, amp_min=0.1, amp_max=0.3, day=96.0, tick=4.0)
    a, b = DiurnalAvailability(**kw), R.DiurnalAvailability(**kw)
    ids = np.arange(512)
    np.testing.assert_array_equal(a.phase(ids), b.phase(ids))
    np.testing.assert_array_equal(a.amplitude(ids), b.amplitude(ids))
    for t in (0.0, 8.0, 11.9, 30.0, 95.0, 250.0):
        np.testing.assert_array_equal(a.duty(ids, t), b.duty(ids, t))
        np.testing.assert_array_equal(a.available(ids, t),
                                      b.available(ids, t))
    clock = [12.0]
    fa = a.availability_fn(lambda: clock[0])
    fb = b.availability_fn(lambda: clock[0])
    assert [fa(c, 0) for c in range(64)] == [fb(c, 0) for c in range(64)]
    skw = dict(seed=11, class_mults=(1.0, 2.0, 4.0),
               class_weights=(0.5, 0.35, 0.15), sigma=0.2)
    sa, sb = DeviceSpeedProfile(**skw), R.DeviceSpeedProfile(**skw)
    ids = np.arange(4000)
    np.testing.assert_array_equal(sa.speed_class(ids), sb.speed_class(ids))
    np.testing.assert_array_equal(sa.multiplier(ids), sb.multiplier(ids))


def test_heterogeneous_plan_bit_identical():
    ids = np.arange(300)
    for speed in (None, dict(seed=2, class_mults=(1.0, 3.0),
                             class_weights=(0.5, 0.5), sigma=0.3)):
        kw = dict(seed=4, straggler_frac=0.2, crash_prob=0.05)
        a = HeterogeneousFaultPlan(
            speed=None if speed is None else DeviceSpeedProfile(**speed), **kw)
        b = R.HeterogeneousFaultPlan(
            speed=None if speed is None else R.DeviceSpeedProfile(**speed),
            **kw)
        assert isinstance(a, FaultPlan) and a.active == b.active
        for rnd in (0, 3, 50):
            np.testing.assert_array_equal(a.latency(ids, rnd),
                                          b.latency(ids, rnd))
            oa = a.round_outcome(ids[:20], rnd, 2.0, target_k=10, quorum_k=5)
            ob = b.round_outcome(ids[:20], rnd, 2.0, target_k=10, quorum_k=5)
            np.testing.assert_array_equal(oa.arrival, ob.arrival)
            assert oa.close_time == ob.close_time


@pytest.mark.parametrize("regime", REGIMES)
def test_make_workload_regimes_bit_identical(regime):
    a, b = make_workload(regime, seed=1), r_make_workload(regime, seed=1)
    assert isinstance(a, WorkloadTrace)
    assert a.horizon == b.horizon
    np.testing.assert_array_equal(a.arrivals.arrivals(a.horizon),
                                  b.arrivals.arrivals(b.horizon))
    assert (a.plan is None) == (b.plan is None)
    assert (a.availability is None) == (b.availability is None)
    ids = np.arange(200)
    if a.plan is not None:
        assert a.plan.active == b.plan.active
        np.testing.assert_array_equal(a.plan.latency(ids, 2),
                                      b.plan.latency(ids, 2))
    if a.availability is not None:
        np.testing.assert_array_equal(a.availability.available(ids, 20.0),
                                      b.availability.available(ids, 20.0))
    with pytest.raises(ValueError):
        make_workload("nope")


def _drive(core, Driver, regime, seed, inflight, queue, backoff, **task_kw):
    """One online run with the reference's stub trainer; returns the
    driver and its telemetry log."""
    pool = core.ClientPoolState.random(40, 10, np.random.default_rng(0))
    budget = float(np.round(0.5 * pool.costs.sum()))

    def template(i, t):
        return core.TaskRequest(budget=budget, n_star=8, subset_size=8,
                                subset_delta=2, max_periods=2, max_rounds=4,
                                round_chunk=2, seed=i, **task_kw)

    trace = core.make_workload(regime, seed=seed, template=template,
                               horizon=16.0 if regime == "saturating"
                               else 32.0)
    provider = core.FLServiceProvider(
        core.ClientPoolState.from_profiles(pool.to_profiles()))
    sched = core.ServiceScheduler(provider, max_inflight=inflight,
                                  max_queue=queue)
    drv = Driver(sched, trace, ChunkStub, backoff=backoff)
    return drv, drv.run()


class _PortCore:
    ClientPoolState = ClientPoolState
    FLServiceProvider = FLServiceProvider
    ServiceScheduler = ServiceScheduler
    TaskRequest = TaskRequest
    make_workload = staticmethod(make_workload)


def _digest(events):
    return [(e.period, e.round_index, tuple(e.subset),
             tuple(np.asarray(e.weights).tolist()), e.metrics)
            for e in events]


@pytest.mark.parametrize("regime,seed,inflight,queue,backoff,task_kw", [
    ("saturating", 1, 2, 1, 0.5, {}),
    ("diurnal", 3, 4, 4, 1.0, dict(overschedule_factor=1.5, quorum_frac=0.25,
                                   collect_deadline=4.0, max_retries=5))])
def test_online_driver_telemetry_matches_reference(regime, seed, inflight,
                                                   queue, backoff, task_kw):
    pd, plog = _drive(_PortCore, OnlineDriver, regime, seed, inflight, queue,
                      backoff, **task_kw)
    rd, rlog = _drive(R, ROnlineDriver, regime, seed, inflight, queue,
                      backoff, **task_kw)
    assert [(e.kind, e.time, e.task, e.data) for e in plog.events] == \
        [(e.kind, e.time, e.task, e.data) for e in rlog.events]
    assert plog.summary() == rlog.summary()
    assert plog.format_summary() == rlog.format_summary()
    assert pd.phases == rd.phases
    assert sorted(pd.results) == sorted(rd.results)
    for i in pd.results:
        assert _digest(pd.results[i]) == _digest(rd.results[i]), i
    s = plog.summary()
    assert s["tasks_finished"] == s["tasks_submitted"] > 0
    if regime == "saturating":
        assert s["rejects"] > 0, "backpressure never fired; vacuous"
    else:
        assert s["round_latency_p99"] is not None


def test_telemetry_summary_matches_reference():
    class _Ev:
        period, round_index, subset = 0, 0, [1, 2]
        metrics = {"round_latency": 2.5}

    logs = []
    for Log in (TelemetryLog, RTelemetryLog):
        log = Log()
        log.record("submit", 0.0, 0, arrival=0.0)
        log.record("reject", 0.0, 0, queued=2, reason="full", attempt=0,
                   retry_at=1.0)
        log.record("accept", 1.0, 0, tid=0, attempt=1)
        log.record_round(3.5, 0, _Ev())
        log.record("done", 3.5, 0, tid=0, phase="DONE", periods=1)
        logs.append(log)
    a, b = logs
    assert a.summary() == b.summary()
    assert a.format_summary() == b.format_summary()
    np.testing.assert_array_equal(a.round_latencies(), b.round_latencies())
    np.testing.assert_array_equal(a.queue_waits(), b.queue_waits())
    assert TelemetryLog().summary() == RTelemetryLog().summary()
