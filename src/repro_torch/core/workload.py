"""Trace generation for the online workload harness (production plane).

A steady-state bench drives the service with fleets of
identical tasks submitted all at once. A production FL *service* sees
none of that: tasks arrive as traffic (smooth or bursty), clients drift
in and out on diurnal waves, and device speeds span orders of magnitude
(the deployed-FL surveys in PAPERS.md call out exactly these gaps
between simulation and practice). This module generates all three
signals as **seeded, counter-based traces** in the
:class:`~repro_torch.core.faults.FaultPlan` splitmix64 idiom:

- every draw is a pure function of ``(seed, stream, counter)`` — no
  stateful RNG anywhere — so a trace replays **bit-identically** and is
  **order-independent**: querying windows/clients/chunks in any order,
  or in any chunking, yields the same numbers (tested in
  tests/test_workload.py);
- traces are cheap to evaluate lazily: the driver
  (:mod:`repro_torch.core.driver`) asks for exactly the windows it reaches.

Three generators plus a bundle:

- :class:`ArrivalTrace` — task arrivals. Time is cut into fixed
  ``window``-length windows; each window draws a Poisson arrival count
  (inverse-CDF from one counter-based uniform) and uniform arrival
  offsets. ``burst_prob``/``burst_rate`` turn the constant-rate Poisson
  process into a two-state MMPP (Markov-modulated Poisson): a window is
  a *burst* window with probability ``burst_prob`` and draws at
  ``burst_rate`` instead — bursty, overdispersed traffic from the same
  counter-based machinery.
- :class:`DiurnalAvailability` — per-client availability waves. Each
  client has a fixed phase and amplitude (drawn once from the seed);
  its duty cycle at time ``t`` is a clipped sinusoid over the ``day``
  period around ``base``, and availability is re-drawn per
  ``tick``-length window against that duty. Mean duty over a full day
  is ``base`` (the sinusoid averages out) — the tolerance checked in
  tests. Composable with the lifecycle's ``availability_fn`` seam via
  :meth:`DiurnalAvailability.availability_fn`.
- :class:`DeviceSpeedProfile` — heterogeneous device speeds. Each
  client draws a speed *class* (e.g. flagship/mid/low-end multipliers,
  weighted) plus per-client lognormal jitter (Box–Muller over two
  counter-based uniforms), going beyond the binary chronic-straggler
  trait of :class:`~repro_torch.core.faults.FaultPlan`.
  :class:`HeterogeneousFaultPlan` composes the two: a ``FaultPlan``
  whose per-round latencies are scaled by the profile's per-client
  multiplier, so speed classes, chronic stragglers, crashes and
  outages all ride the same ``round_outcome`` evaluation.
- :class:`WorkloadTrace` — the bundle the driver consumes: an arrival
  trace, an optional availability trace, an optional fault plan, a
  per-arrival ``TaskRequest`` template factory, and a horizon.
  :func:`make_workload` ships the three named regimes the workload
  bench studies (``light`` / ``saturating`` / ``bursty``) plus
  ``steady`` and ``diurnal`` presets for the demo.

All times are unitless simulated time, the same axis as
``FaultPlan.base_latency`` and the lifecycle's
``metrics["round_latency"]`` (docs/robustness.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .faults import FaultPlan, _u01

# stream ids for this module's counter-based draws (FaultPlan owns 1-5)
_S_BURST = 11        # per-window burst state
_S_COUNT = 12        # per-window arrival count
_S_OFFSET = 13       # per-(window, j) arrival offset
_S_PHASE = 21        # per-client diurnal phase
_S_AMP = 22          # per-client diurnal amplitude
_S_AVAIL = 23        # per-(client, tick) availability draw
_S_CLASS = 31        # per-client speed class
_S_JIT1 = 32         # per-client lognormal jitter (Box-Muller u1)
_S_JIT2 = 33         # per-client lognormal jitter (Box-Muller u2)


def _poisson_icdf(mean: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Vectorized Poisson inverse CDF: the smallest k with
    ``CDF(k) > u``, evaluated by walking the pmf recurrence. Exact for
    the small per-window means traces use (the loop is bounded by the
    largest count actually drawn, not a fixed cap)."""
    mean = np.asarray(mean, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    pmf = np.exp(-mean)
    cdf = pmf.copy()
    counts = np.zeros(u.shape, dtype=np.int64)
    active = u >= cdf
    k = 0
    while active.any():
        k += 1
        pmf = pmf * mean / k
        cdf = cdf + pmf
        counts[active] = k
        active = u >= cdf
        if k > 1000:                    # numerically unreachable guard
            break                       # pragma: no cover
    return counts


def _box_muller(u1: np.ndarray, u2: np.ndarray) -> np.ndarray:
    """Standard normals from two counter-based uniform arrays."""
    r = np.sqrt(-2.0 * np.log(np.maximum(1.0 - u1, 1e-300)))
    return r * np.cos(2.0 * np.pi * u2)


# ---------------------------------------------------------------------------
# Task arrivals: Poisson / bursty MMPP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """Counter-based task-arrival process.

    ``rate`` is the mean arrival rate (tasks per time unit) of a normal
    window; with ``burst_prob > 0`` each window is independently a
    *burst* window (probability ``burst_prob``) drawing at
    ``burst_rate`` instead — a discrete-window two-state MMPP. Every
    window's count and offsets are keyed by the window index alone, so
    any window can be evaluated independently, in any order.
    """

    seed: int = 0
    rate: float = 1.0
    window: float = 8.0
    burst_rate: float = 0.0
    burst_prob: float = 0.0

    def is_burst(self, w) -> np.ndarray:
        """(W,) bool — whether each window index draws at burst rate."""
        w = np.atleast_1d(np.asarray(w, dtype=np.int64))
        if self.burst_prob <= 0.0:
            return np.zeros(w.shape, dtype=bool)
        return _u01(self.seed, _S_BURST, w) < self.burst_prob

    def window_rate(self, w) -> np.ndarray:
        """(W,) float — each window's arrival rate."""
        w = np.atleast_1d(np.asarray(w, dtype=np.int64))
        return np.where(self.is_burst(w), self.burst_rate, self.rate)

    def counts(self, w) -> np.ndarray:
        """(W,) int — Poisson arrival counts per window."""
        w = np.atleast_1d(np.asarray(w, dtype=np.int64))
        mean = self.window_rate(w) * self.window
        return _poisson_icdf(mean, _u01(self.seed, _S_COUNT, w))

    def window_arrivals(self, w: int) -> np.ndarray:
        """Sorted arrival times inside window ``w`` (ascending)."""
        w = int(w)
        n = int(self.counts(w)[0])
        if n == 0:
            return np.zeros(0, dtype=np.float64)
        offs = _u01(self.seed, _S_OFFSET, np.arange(n), extra=w)
        return w * self.window + self.window * np.sort(offs)

    def arrivals(self, t_end: float) -> np.ndarray:
        """All arrival times in ``[0, t_end)``, ascending. Chunk- and
        order-independent: equals the concatenation of the per-window
        queries in any decomposition."""
        t_end = float(t_end)
        n_windows = int(np.ceil(t_end / self.window))
        parts = [self.window_arrivals(w) for w in range(n_windows)]
        times = (np.concatenate(parts) if parts
                 else np.zeros(0, dtype=np.float64))
        return times[times < t_end]


# ---------------------------------------------------------------------------
# Diurnal client availability
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiurnalAvailability:
    """Per-client diurnal availability waves.

    Client ``c``'s duty cycle at time ``t`` is::

        duty(c, t) = clip(base + amp_c * sin(2*pi*(t/day + phase_c)), 0, 1)

    with ``phase_c`` uniform in [0, 1) and ``amp_c`` uniform in
    ``[amp_min, amp_max]``, both fixed per client by the seed. Whether
    the client is actually available is re-drawn once per
    ``tick``-length window against that duty — counter-based on
    ``(client, tick)``, so any (client, time) cell evaluates
    independently. Averaged over a full day the duty is ``base``.
    """

    seed: int = 0
    base: float = 0.75
    amp_min: float = 0.1
    amp_max: float = 0.4
    day: float = 96.0
    tick: float = 4.0

    def phase(self, ids) -> np.ndarray:
        return _u01(self.seed, _S_PHASE, ids)

    def amplitude(self, ids) -> np.ndarray:
        u = _u01(self.seed, _S_AMP, ids)
        return self.amp_min + (self.amp_max - self.amp_min) * u

    def duty(self, ids, t: float) -> np.ndarray:
        """(K,) float — each client's availability probability at ``t``."""
        ids = np.atleast_1d(np.asarray(ids))
        wave = np.sin(2.0 * np.pi * (float(t) / self.day + self.phase(ids)))
        return np.clip(self.base + self.amplitude(ids) * wave, 0.0, 1.0)

    def available(self, ids, t: float) -> np.ndarray:
        """(K,) bool — availability at time ``t`` (constant within a
        tick window)."""
        ids = np.atleast_1d(np.asarray(ids))
        tick = int(np.floor(float(t) / self.tick))
        u = _u01(self.seed, _S_AVAIL, ids, extra=tick)
        return u < self.duty(ids, tick * self.tick)

    def availability_fn(self, now_fn: Callable[[], float]
                        ) -> Callable[[int, int], bool]:
        """Adapter onto the lifecycle's ``availability_fn(cid, period)``
        seam: the period argument is ignored in favour of the driver's
        virtual clock (``now_fn``), so period checkpoints see the
        availability wave at the simulated time they actually happen."""
        def fn(cid: int, period: int) -> bool:
            return bool(self.available([int(cid)], now_fn())[0])
        return fn


# ---------------------------------------------------------------------------
# Heterogeneous device speeds
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceSpeedProfile:
    """Per-client speed multipliers: weighted speed classes with
    lognormal within-class jitter.

    ``class_mults``/``class_weights`` define the device tiers (a
    multiplier scales round latency, so 1.0 = reference speed, 4.0 =
    4x slower); each client draws its class once from the seed, then a
    lognormal jitter ``exp(sigma * z)`` (Box–Muller ``z`` from two
    counter-based uniforms) spreads devices within the class. All draws
    are keyed by client id — evaluation order never matters.
    """

    seed: int = 0
    class_mults: tuple[float, ...] = (1.0, 2.0, 4.0)
    class_weights: tuple[float, ...] = (0.5, 0.35, 0.15)
    sigma: float = 0.25

    def speed_class(self, ids) -> np.ndarray:
        """(K,) int — each client's speed-class index."""
        ids = np.atleast_1d(np.asarray(ids))
        w = np.asarray(self.class_weights, dtype=np.float64)
        cum = np.cumsum(w / w.sum())
        u = _u01(self.seed, _S_CLASS, ids)
        return np.minimum(np.searchsorted(cum, u, side="right"),
                          len(self.class_mults) - 1)

    def multiplier(self, ids) -> np.ndarray:
        """(K,) float — latency multiplier per client (class x jitter)."""
        ids = np.atleast_1d(np.asarray(ids))
        base = np.asarray(self.class_mults,
                          dtype=np.float64)[self.speed_class(ids)]
        z = _box_muller(_u01(self.seed, _S_JIT1, ids),
                        _u01(self.seed, _S_JIT2, ids))
        return base * np.exp(self.sigma * z)


@dataclasses.dataclass(frozen=True)
class HeterogeneousFaultPlan(FaultPlan):
    """A :class:`~repro_torch.core.faults.FaultPlan` whose per-round latencies
    are additionally scaled by a :class:`DeviceSpeedProfile` — chronic
    stragglers, crashes, outages and device tiers all evaluated by the
    same ``round_outcome`` first-k/deadline machinery. A plan whose
    profile multiplies by anything other than 1 is *active* even with
    every failure rate at zero (its latencies differ from the
    homogeneous plan), so the lifecycle takes the fault-mode path and
    emits ``round_latency`` metrics."""

    speed: DeviceSpeedProfile | None = None

    @property
    def active(self) -> bool:
        if self.speed is not None:
            return True
        return FaultPlan.active.fget(self)

    def latency(self, ids, round_index: int) -> np.ndarray:
        lat = FaultPlan.latency(self, ids, round_index)
        if self.speed is None:
            return lat
        return lat * self.speed.multiplier(ids)


# ---------------------------------------------------------------------------
# The bundle the driver consumes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkloadTrace:
    """One online workload: arrivals + availability + device behaviour
    + the per-arrival task template.

    ``template(index, time)`` builds the :class:`TaskRequest` for the
    ``index``-th arrival (at trace time ``time``); the driver varies
    nothing else, so two arms sharing a trace but differing in template
    (policy / mitigation knobs) see the *same* traffic. ``plan`` is
    attached to the trainers the driver builds (any object with a
    ``fault_plan`` attribute rides the lifecycle's fault seam).
    """

    arrivals: ArrivalTrace
    template: Callable[[int, float], "object"]
    horizon: float = 64.0
    availability: DiurnalAvailability | None = None
    plan: FaultPlan | None = None


def make_workload(regime: str, seed: int = 0,
                  template: Callable[[int, float], "object"] | None = None,
                  horizon: float | None = None) -> WorkloadTrace:
    """Named workload presets (the regimes the workload bench studies).

    - ``light`` — low-rate Poisson arrivals, straggler-laden
      heterogeneous fleet; the service is never queue-bound.
    - ``saturating`` — Poisson arrivals fast enough to keep the intake
      queue full; completion time is dominated by queueing + round
      latency (the regime the reference's workload bench measures).
    - ``bursty`` — MMPP arrivals: long quiet stretches punctured by
      burst windows at many times the base rate.
    - ``steady`` — everything at time zero, no availability wave, no
      fault plan: the no-trace identity regime (bit-identical to
      driving the ``ServiceScheduler`` directly).
    - ``diurnal`` — light arrivals plus a strong availability wave
      (for the demo; period checkpoints visibly shed clients).

    ``template`` defaults to ``None`` — callers must set one before the
    driver runs (the bench and demo bring their own); it is a required
    argument of :class:`WorkloadTrace` consumers, not of the trace.
    """
    speed = DeviceSpeedProfile(seed=seed + 3)
    plan = HeterogeneousFaultPlan(
        seed=seed + 1, straggler_frac=0.2, straggler_slowdown=8.0,
        crash_prob=0.02, speed=speed)
    if regime == "light":
        arr = ArrivalTrace(seed=seed, rate=0.25, window=8.0)
        trace = WorkloadTrace(arr, template, horizon=64.0, plan=plan)
    elif regime == "saturating":
        arr = ArrivalTrace(seed=seed, rate=1.5, window=8.0)
        trace = WorkloadTrace(arr, template, horizon=48.0, plan=plan)
    elif regime == "bursty":
        arr = ArrivalTrace(seed=seed, rate=0.125, window=8.0,
                           burst_rate=3.0, burst_prob=0.25)
        trace = WorkloadTrace(arr, template, horizon=64.0, plan=plan)
    elif regime == "steady":
        arr = ArrivalTrace(seed=seed, rate=0.0, window=8.0)
        trace = WorkloadTrace(arr, template, horizon=8.0)
    elif regime == "diurnal":
        arr = ArrivalTrace(seed=seed, rate=0.25, window=8.0)
        avail = DiurnalAvailability(seed=seed + 2, base=0.7,
                                    amp_min=0.2, amp_max=0.5,
                                    day=48.0, tick=4.0)
        trace = WorkloadTrace(arr, template, horizon=64.0,
                              availability=avail, plan=plan)
    else:
        raise ValueError(f"unknown workload regime {regime!r}; known: "
                         f"light, saturating, bursty, steady, diurnal")
    if horizon is not None:
        trace.horizon = float(horizon)
    return trace
