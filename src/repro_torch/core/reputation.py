"""Reputation tracking and pool maintenance (paper §V-B steps 2-4).

Per-round model quality q_t = sim(w_l, w_g) (Eq. in §IV-C) and behavior
b_t ∈ {0,1} (Eq. 4) are recorded for each participating client; per-task
values are the averages over participated rounds (Eqs. 3/5); the
reputation score is s_rep = q_task + b_task.

``ReputationTracker`` stores everything as struct-of-arrays keyed by
pool position: per-round q/b histories live in ``(P, C)`` buffers
(capacity-doubled on both axes) next to the per-client round cursor and
suspension counter, so the whole tracker serializes to plain numpy
arrays (``to_arrays``/``from_arrays`` — the ``core.lifecycle`` TaskState
checkpoint path) with no dataclass pickling. The legacy per-client
``records`` mapping survives as a live view: ``tracker.records[cid]``
returns a :class:`ReputationRecord` proxy whose ``q_rounds``/``b_rounds``
are array slices of the shared buffers.

``update_pool`` implements step 4 of the scheduling period:
  - remove clients unavailable in the next period;
  - remove clients with bad reputation in the current period (suspend);
  - re-add clients whose suspension has expired.
"""
from __future__ import annotations

from typing import Iterator, Mapping, Sequence

import numpy as np

from .criteria import cosine_similarity, per_task_average


class ReputationRecord:
    """Per-client view into a :class:`ReputationTracker`'s arrays.

    Mirrors the pre-SoA dataclass API (``q_rounds``, ``b_rounds``,
    ``q_task``, ``b_task``, ``s_rep``, ``suspended_until``) but owns no
    storage: reads and writes go straight to the tracker's buffers.
    """

    __slots__ = ("_tracker", "_pos")

    def __init__(self, tracker: "ReputationTracker", pos: int):
        self._tracker = tracker
        self._pos = int(pos)

    @property
    def num_rounds(self) -> int:
        return int(self._tracker._n[self._pos])

    @property
    def q_rounds(self) -> np.ndarray:
        return self._tracker._q[self._pos, : self.num_rounds]

    @property
    def b_rounds(self) -> np.ndarray:
        return self._tracker._b[self._pos, : self.num_rounds]

    @property
    def q_task(self) -> float:
        return per_task_average(self.q_rounds)

    @property
    def b_task(self) -> float:
        return per_task_average(self.b_rounds)

    @property
    def s_rep(self) -> float:
        """s_rep = q_task + b_task (paper §V-B)."""
        return self.q_task + self.b_task

    @property
    def suspended_until(self) -> int:
        return int(self._tracker._susp[self._pos])

    @suspended_until.setter
    def suspended_until(self, period: int) -> None:
        self._tracker._susp[self._pos] = int(period)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ReputationRecord(rounds={self.num_rounds}, "
                f"s_rep={self.s_rep:.3f}, "
                f"suspended_until={self.suspended_until})")


class _RecordsView(Mapping):
    """Dict-compatible live view: ``client_id -> ReputationRecord``."""

    __slots__ = ("_tracker",)

    def __init__(self, tracker: "ReputationTracker"):
        self._tracker = tracker

    def __getitem__(self, client_id: int) -> ReputationRecord:
        return ReputationRecord(self._tracker,
                                self._tracker._pos[int(client_id)])

    def __iter__(self) -> Iterator[int]:
        return iter(self._tracker._pos)

    def __len__(self) -> int:
        return len(self._tracker._pos)

    def __contains__(self, client_id) -> bool:
        return int(client_id) in self._tracker._pos


class ReputationTracker:
    """Tracks per-round scores within one FL task and maintains the pool.

    Struct-of-arrays over pool positions: row ``i`` belongs to
    ``client_ids[i]`` (insertion order — stage-1 selection order, then
    any churn admissions via :meth:`add_clients`).
    """

    _ROUNDS_CAP0 = 8     # initial per-client round capacity

    def __init__(self, client_ids, suspension_periods: int = 1,
                 rep_threshold: float = 0.5):
        ids = [int(k) for k in client_ids]
        self.suspension_periods = int(suspension_periods)
        self.rep_threshold = float(rep_threshold)
        self.period = 0
        P = len(ids)
        self._ids = np.array(ids, dtype=np.int64)
        self._q = np.zeros((P, self._ROUNDS_CAP0), dtype=np.float64)
        self._b = np.zeros((P, self._ROUNDS_CAP0), dtype=np.float64)
        self._n = np.zeros(P, dtype=np.int64)          # per-client cursor
        self._susp = np.full(P, -1, dtype=np.int64)    # suspended until
        self._tf = np.zeros(P, dtype=np.int64)         # timing failures:
        # rounds this client was scheduled but missed the collect close
        # (fed by lifecycle fault-mode dispatch; selection policies read
        # it to penalize chronic stragglers)
        self._pos = {cid: i for i, cid in enumerate(ids)}
        if len(self._pos) != P:
            raise ValueError("duplicate client ids")

    # -- shape / views -------------------------------------------------------
    @property
    def client_ids(self) -> np.ndarray:
        return self._ids

    @property
    def records(self) -> _RecordsView:
        """Legacy ``dict[int, record]`` compatibility view (live)."""
        return _RecordsView(self)

    def add_clients(self, client_ids) -> None:
        """Register additional clients (churn admissions between periods).

        New rows start with zero rounds and no suspension, exactly like
        clients present from stage 1.
        """
        new = []
        for k in client_ids:
            k = int(k)
            if k in self._pos:
                raise ValueError(f"client {k} already tracked")
            new.append(k)
        if not new:
            return
        P, C = self._q.shape
        self._ids = np.concatenate([self._ids,
                                    np.array(new, dtype=np.int64)])
        grow = np.zeros((len(new), C), dtype=np.float64)
        self._q = np.concatenate([self._q, grow])
        self._b = np.concatenate([self._b, grow.copy()])
        self._n = np.concatenate([self._n, np.zeros(len(new), np.int64)])
        self._susp = np.concatenate([self._susp,
                                     np.full(len(new), -1, np.int64)])
        self._tf = np.concatenate([self._tf,
                                   np.zeros(len(new), np.int64)])
        for j, cid in enumerate(new):
            self._pos[cid] = P + j

    def _grow_rounds(self) -> None:
        P, C = self._q.shape
        pad = np.zeros((P, C), dtype=np.float64)
        self._q = np.concatenate([self._q, pad], axis=1)
        self._b = np.concatenate([self._b, pad.copy()], axis=1)

    # -- step 2: per-round updates -----------------------------------------
    def record_round(self, client_id: int, returned: bool,
                     local_update=None, global_update=None,
                     q_value: float | None = None) -> None:
        """Record one round's participation for one client.

        q_t is the cosine similarity between the client's local update and
        the aggregated global update (computed by the caller or here from
        the raw vectors); on a dropped round (returned=False) q_t
        contributes 0 and b_t = 0 per Eq. (4).
        """
        i = self._pos[int(client_id)]
        if returned:
            if q_value is None:
                if local_update is None or global_update is None:
                    raise ValueError(
                        "need q_value or (local_update, global_update)")
                q_value = cosine_similarity(local_update, global_update)
            q, b = float(q_value), 1.0
        else:
            q, b = 0.0, 0.0
        j = int(self._n[i])
        if j >= self._q.shape[1]:
            self._grow_rounds()
        self._q[i, j] = q
        self._b[i, j] = b
        self._n[i] = j + 1

    def record_timeout(self, client_id: int) -> None:
        """Charge one timing failure: the client was scheduled for a
        round but had not reported by the round's close (straggler,
        crash, or outage under a fault plan). Orthogonal to
        :meth:`record_round` — a timed-out client of a *committed* round
        is additionally recorded there as ``returned=False``."""
        self._tf[self._pos[int(client_id)]] += 1

    def timeout_counts(self) -> dict[int, int]:
        """``client_id -> timing failures`` over the task so far."""
        return {int(cid): int(self._tf[i])
                for i, cid in enumerate(self._ids)}

    @property
    def timeout_failures(self) -> np.ndarray:
        """(P,) int64 — timing failures per tracked client, aligned with
        :attr:`client_ids`. Copy; mutating it does not touch the
        tracker. The lifecycle publishes this as the ``obs/timeouts``
        policy-state column every period (docs/workloads.md)."""
        return self._tf.copy()

    @property
    def round_counts(self) -> np.ndarray:
        """(P,) int64 — committed rounds recorded per tracked client,
        aligned with :attr:`client_ids` (copy; the ``obs/rounds``
        column)."""
        return self._n.copy()

    # -- steps 3-4: period rollover -----------------------------------------
    def update_pool(self, pool: set[int],
                    availability: Mapping[int, bool] | None = None) -> set[int]:
        """End-of-period pool update. Returns the new active pool."""
        availability = availability or {}
        self.period += 1
        new_pool = set()
        for cid, rec in self.records.items():
            if rec.suspended_until >= self.period:
                continue  # still suspended
            if not availability.get(cid, True):
                continue  # unavailable next period (comes back when available)
            participated = cid in pool and rec.num_rounds > 0
            if participated and rec.s_rep < self.rep_threshold:
                rec.suspended_until = self.period + self.suspension_periods - 1
                continue  # bad reputation: suspend
            new_pool.add(cid)
        return new_pool

    def scores(self) -> dict[int, float]:
        return {cid: rec.s_rep for cid, rec in self.records.items()}

    # -- serialization (TaskState checkpoint path) ---------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        """Flat numpy-array form (no dataclasses, no pickle)."""
        C = int(self._n.max()) if self._n.size else 0
        return {
            "ids": self._ids.copy(),
            "q": self._q[:, :C].copy(),
            "b": self._b[:, :C].copy(),
            "n": self._n.copy(),
            "suspended": self._susp.copy(),
            "meta": np.array([self.period, self.suspension_periods],
                             dtype=np.int64),
            "threshold": np.array([self.rep_threshold], dtype=np.float64),
            "tf": self._tf.copy(),
        }

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, np.ndarray]) -> "ReputationTracker":
        meta = np.asarray(arrays["meta"], dtype=np.int64)
        tr = cls(np.asarray(arrays["ids"], dtype=np.int64),
                 suspension_periods=int(meta[1]),
                 rep_threshold=float(np.asarray(arrays["threshold"])[0]))
        tr.period = int(meta[0])
        P = tr._ids.size
        q = np.asarray(arrays["q"], dtype=np.float64)
        b = np.asarray(arrays["b"], dtype=np.float64)
        q = q.reshape(P, -1) if q.size else q.reshape(P, 0)
        b = b.reshape(P, -1) if b.size else b.reshape(P, 0)
        C = max(q.shape[1], cls._ROUNDS_CAP0)
        tr._q = np.zeros((P, C), dtype=np.float64)
        tr._b = np.zeros((P, C), dtype=np.float64)
        tr._q[:, : q.shape[1]] = q
        tr._b[:, : b.shape[1]] = b
        tr._n = np.asarray(arrays["n"], dtype=np.int64).copy()
        tr._susp = np.asarray(arrays["suspended"], dtype=np.int64).copy()
        tf = arrays.get("tf")      # absent in pre-fault checkpoints
        if tf is not None:
            tr._tf = np.asarray(tf, dtype=np.int64).copy()
        return tr


def model_quality_batch(local_updates: np.ndarray,
                        global_update: np.ndarray) -> np.ndarray:
    """Vectorized q_t for a round: cosine(local_k, global) for each k.

    local_updates: (K, P) flattened client updates; global_update: (P,).
    """
    L = np.asarray(local_updates, dtype=np.float64)
    g = np.asarray(global_update, dtype=np.float64).ravel()
    ln = np.linalg.norm(L, axis=1)
    gn = np.linalg.norm(g)
    denom = np.maximum(ln * gn, 1e-12)
    return (L @ g) / denom
