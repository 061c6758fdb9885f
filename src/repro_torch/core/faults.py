"""Deterministic fault injection for FL round execution (robustness
plane).

Real FL fleets are dominated by device heterogeneity: stragglers,
mid-round crashes, transient outages, permanent departures (the client
-selection surveys in PAPERS.md enumerate exactly these axes). The
service plane models them through one seeded :class:`FaultPlan` — a
*pure function* from ``(plan.seed, client_id, round)`` to latencies and
failure events, built on counter-based splitmix64 hashing rather than
stateful RNGs, so:

- every scenario replays bit-identically (tests, checkpoint/resume,
  benchmark baselines share one plan);
- outcomes for a client/round never depend on evaluation order, how
  rounds are chunked, or which other clients are scheduled;
- the lifecycle can evaluate a round's arrivals *at dispatch time*
  (``round_outcome``) and mask non-arriving clients on device before
  any training runs — simulation-honest straggler mitigation with no
  wall-clock sleeps anywhere.

The plan is attached to a trainer (``DeviceFLSim(...,
fault_plan=plan)`` or any object with a ``fault_plan`` attribute); the
lifecycle reads it with ``getattr``. A plan with every rate at zero is
*inactive* (:attr:`FaultPlan.active` is False) and the lifecycle takes
the unmodified no-fault code path — bit-identical to a trainer with no
plan at all (asserted in tests/test_faults.py and
benchmarks/bench_faults.py).

Latencies are unitless simulated time: ``base_latency`` is a healthy
client's round time, ``collect_deadline`` / ``retry_backoff`` on
:class:`~repro_torch.core.lifecycle.TaskRequest` are expressed in the same
units, and the per-round ``metrics["round_latency"]`` the lifecycle
emits is the simulated close time of the round.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(z: np.ndarray) -> np.ndarray:
    """Finalizer of the splitmix64 generator, vectorized over uint64."""
    z = (z + _GOLDEN) & _MASK64
    z = ((z ^ (z >> np.uint64(30))) * _MIX1) & _MASK64
    z = ((z ^ (z >> np.uint64(27))) * _MIX2) & _MASK64
    return z ^ (z >> np.uint64(31))


def _u01(seed: int, stream: int, ids, extra=0) -> np.ndarray:
    """I.i.d.-looking uniforms in [0, 1) keyed by ``(seed, stream,
    client_id, extra)`` — counter-based, so any tuple can be evaluated
    independently and out of order."""
    ids = np.atleast_1d(np.asarray(ids)).astype(np.uint64)
    extra = np.asarray(extra).astype(np.uint64)
    with np.errstate(over="ignore"):
        h = _splitmix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
                        ^ ((np.uint64(stream) * _GOLDEN) & _MASK64))
        h = _splitmix64(ids ^ h)
        h = _splitmix64(h ^ ((extra * _MIX1) & _MASK64))
    return (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


@dataclasses.dataclass(frozen=True)
class RoundOutcome:
    """Arrival evaluation of one round under a :class:`FaultPlan`."""

    arrival: np.ndarray     # (K,) bool — reported by the close time
    latency: np.ndarray     # (K,) float — per-client report time (inf =
    # never: crashed, in outage, or permanently dead this round)
    close_time: float       # simulated time the round closed: min of the
    # deadline and the target_k-th arrival (first-k-collect)
    n_arrived: int
    quorum_met: bool        # n_arrived >= quorum_k


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, deterministic per-client fault model.

    All rates default to zero — the all-zero plan is :attr:`active` ==
    False and injects nothing. Fields:

    - ``straggler_frac`` — fraction of clients that are *chronic*
      stragglers (a fixed per-client trait drawn once from the seed);
      their round latency is multiplied by ``straggler_slowdown``.
    - ``base_latency`` / ``latency_jitter`` — a healthy client's round
      time is ``base_latency * (1 + jitter*U[-1,1))`` per (client,
      round).
    - ``crash_prob`` — per-(client, round) probability of a transient
      mid-round crash (the update is lost; the client is back next
      round).
    - ``permanent_frac`` — converts a fraction of the crash rate into
      *permanent* death: each client permanently departs at a geometric
      round with per-round rate ``crash_prob * permanent_frac``.
    - ``outage_prob`` / ``outage_len`` — flaky-rejoin churn: in each
      window of ``outage_len`` rounds a client is offline with
      probability ``outage_prob`` (and rejoins in the next window).
    """

    seed: int = 0
    straggler_frac: float = 0.0
    straggler_slowdown: float = 4.0
    base_latency: float = 1.0
    latency_jitter: float = 0.25
    crash_prob: float = 0.0
    permanent_frac: float = 0.0
    outage_prob: float = 0.0
    outage_len: int = 5

    @property
    def active(self) -> bool:
        """Whether this plan can change any outcome. Inactive plans are
        treated by the lifecycle exactly like no plan at all (the
        bit-identity contract)."""
        return (self.straggler_frac > 0.0 or self.crash_prob > 0.0
                or self.outage_prob > 0.0)

    # -- per-client / per-round draws ---------------------------------------
    def is_straggler(self, ids) -> np.ndarray:
        """(K,) bool — the fixed chronic-straggler trait."""
        return _u01(self.seed, 1, ids) < self.straggler_frac

    def latency(self, ids, round_index: int) -> np.ndarray:
        """(K,) float — simulated report latency, ignoring crashes."""
        u = _u01(self.seed, 2, ids, extra=int(round_index))
        jit = 1.0 + self.latency_jitter * (2.0 * u - 1.0)
        slow = np.where(self.is_straggler(ids),
                        self.straggler_slowdown, 1.0)
        return self.base_latency * slow * jit

    def death_round(self, ids) -> np.ndarray:
        """(K,) float — the round at which each client permanently
        departs (inf = never). Geometric with per-round rate
        ``crash_prob * permanent_frac``, drawn in O(1) per client."""
        ids = np.atleast_1d(np.asarray(ids))
        p = self.crash_prob * self.permanent_frac
        if p <= 0.0:
            return np.full(ids.shape[0], np.inf)
        u = _u01(self.seed, 3, ids)
        return np.floor(np.log1p(-u) / np.log1p(-min(p, 1.0 - 1e-12)))

    def crashed(self, ids, round_index: int) -> np.ndarray:
        """(K,) bool — transient mid-round crash this round."""
        ids = np.atleast_1d(np.asarray(ids))
        if self.crash_prob <= 0.0:
            return np.zeros(ids.shape[0], dtype=bool)
        return _u01(self.seed, 4, ids, extra=int(round_index)) \
            < self.crash_prob

    def in_outage(self, ids, round_index: int) -> np.ndarray:
        """(K,) bool — offline for this round's outage window."""
        ids = np.atleast_1d(np.asarray(ids))
        if self.outage_prob <= 0.0:
            return np.zeros(ids.shape[0], dtype=bool)
        win = int(round_index) // max(1, int(self.outage_len))
        return _u01(self.seed, 5, ids, extra=win) < self.outage_prob

    def alive(self, ids, round_index: int) -> np.ndarray:
        """(K,) bool — will this client report this round at all."""
        ids = np.atleast_1d(np.asarray(ids))
        return ((round_index < self.death_round(ids))
                & ~self.in_outage(ids, round_index)
                & ~self.crashed(ids, round_index))

    # -- round evaluation ----------------------------------------------------
    def round_outcome(self, ids, round_index: int, deadline: float,
                      target_k: int, quorum_k: int) -> RoundOutcome:
        """Evaluate one round's arrivals (first-k-collect semantics).

        The round closes at ``min(deadline, latency of the target_k-th
        arrival)``; with no deadline (``deadline <= 0``) it closes at
        the ``target_k``-th arrival, or at the last alive arrival when
        fewer than ``target_k`` clients ever report — the simulation
        never hangs. ``arrival`` marks clients whose latency is within
        the close; ``quorum_met`` is ``n_arrived >= quorum_k``.
        """
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        lat = np.where(self.alive(ids, round_index),
                       self.latency(ids, round_index), np.inf)
        dl = float(deadline) if deadline is not None and deadline > 0 \
            else np.inf
        finite = np.isfinite(lat)
        nf = int(finite.sum())
        k = min(max(int(target_k), 1), lat.size)
        if nf == 0:
            close = dl if np.isfinite(dl) else 0.0
        elif nf >= k:
            close = min(dl, float(np.partition(lat, k - 1)[k - 1]))
        else:
            close = min(dl, float(lat[finite].max()))
        arrival = lat <= close
        n = int(arrival.sum())
        return RoundOutcome(arrival=arrival, latency=lat,
                            close_time=float(close), n_arrived=n,
                            quorum_met=n >= int(quorum_k))
