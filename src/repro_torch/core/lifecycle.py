"""Resumable service lifecycle: the task state machine behind the FL
service provider (paper §III Fig. 1, deployed form).

The blocking ``FLServiceProvider.run_task`` loop owned the Python
control flow for a task's whole lifetime: one task, one frozen client
registry, convergence-or-bust. This module inverts that control. A task
is an explicit, serializable :class:`TaskState` advanced by *pure-ish*
transition functions::

    INTAKE -> POOL_SELECTED -> SCHEDULED -> TRAINING -> ... -> TRAINING
                 ^                                               |
                 +--------------- PERIOD_CHECKPOINT <------------+
                                        |
                                DONE / INFEASIBLE

- :func:`submit` runs stage 1 (pool selection) and returns the state;
- :func:`step` advances exactly one transition, returning the new state
  plus the :class:`RoundEvent` s it produced (a TRAINING step dispatches
  one round chunk to the trainer; everything else is bookkeeping);
- :func:`drain` is the convenience loop (step until DONE/INFEASIBLE) —
  ``run_task`` is now a deprecated shim over ``submit`` + ``drain`` that
  reproduces the pre-redesign results bit-for-bit.

The TRAINING transition additionally splits into an asynchronous half
pair (overlapped dispatch):

- :func:`dispatch` *enqueues* one round chunk — an
  :class:`AsyncTrainer` returns an opaque handle over still-unmaterialized
  device tensors (asynchronous CUDA launches), a plain :class:`Trainer` falls
  back to running the chunk eagerly — and parks it on
  ``TaskState.pending``;
- :func:`collect` materializes the pending handle into
  :class:`RoundEvent` s and advances the phase exactly as a blocking
  step would have.

``step`` on a SCHEDULED/TRAINING state is literally ``dispatch`` +
``collect``, so stepping stays bit-identical to the pre-split code;
:class:`ServiceScheduler` exploits the split to overlap device work
across tasks (dispatch every runnable task, then collect in completion
order) while host-only transitions fill the gaps.

Because the state between steps is explicit, the API expresses the three
things the blocking loop structurally could not:

- **multi-tenant serving** — :class:`ServiceScheduler` holds N in-flight
  TaskStates against one shared ``ClientPoolState``, batches stage-1
  intake through ``select_pools_batch`` and pumps the dispatch/collect
  split so device work from different tasks overlaps (round-robin
  blocking sweeps remain available via ``overlap=False``);
- **client churn** — clients joining the shared pool between periods
  (``ClientPoolState.register``) are admitted into running tasks at
  their next PERIOD_CHECKPOINT (budget permitting, same score/cost-ratio
  greedy as stage 1) without re-running stage 1; deregistered clients
  are dropped from task pools at the same point;
- **checkpoint/resume** — :meth:`TaskState.to_arrays` /
  :meth:`TaskState.from_arrays` round-trip the full control state
  (cursors, pool, reputation arrays, PCG64 rng state, pending schedule,
  the task's policy names and its ``policy_state`` cursor arrays)
  through plain numpy arrays, serialized via the existing
  ``repro_torch.checkpoint`` msgpack path (:func:`save_state` /
  :func:`load_state`), so a killed provider resumes mid-period with
  identical remaining rounds.

Selection and scheduling strategies are pluggable
(:mod:`repro_torch.core.policy`): ``TaskRequest.selection_policy`` /
``scheduling_policy`` name registered policies, resolved by the
provider at each transition — the lifecycle itself never imports a
concrete strategy.

Trainers implement the explicit :class:`Trainer` protocol (one required
method, ``run_rounds``) instead of being duck-typed via
``hasattr("run_rounds")``; :func:`single_round_adapter` wraps legacy
per-round callables.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import (Any, Callable, Mapping, Protocol, Sequence,
                    runtime_checkable)

import numpy as np

from . import placement as placement_mod
from .scheduling import ScheduleResult
from .selection import SelectionResult
from .reputation import ReputationTracker

# rounds of fault-mode round_latency retained in the policy_state
# "obs/latency" window (read by the deadline_aware scheduling policy)
_OBS_LATENCY_WINDOW = 128

_STATE_FORMAT = 4             # to_arrays layout version (4: +
_STATE_FORMATS = (1, 2, 3, 4)  # TaskRequest.compression and
# trainer_state arrays; 3 added fault/mitigation TaskRequest fields,
# retry/backoff cursors, DEGRADED phase, task id; 2 added policy names
# and policy_state arrays; older formats still restore, with defaults)


# ---------------------------------------------------------------------------
# Task intake types (previously in core.service; moved here so the
# provider can shim run_task over the lifecycle without an import cycle)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TaskRequest:
    """An FL task as submitted by a task requester."""
    budget: float
    n_star: int = 1                       # minimum pool size (Eq. 8c)
    thresholds: np.ndarray | None = None  # per-criterion minimums (Eq. 8d)
    subset_size: int = 10                 # n
    subset_delta: int = 3                 # δ
    x_star: int = 3                       # max selections per period
    max_periods: int = 20
    max_rounds: int | None = None         # hard round budget; chunked
    # dispatch never trains past it (unlike a stop_fn, which a chunk can
    # only observe at its host checkpoint)
    rep_threshold: float = 0.5
    suspension_periods: int = 1
    scheduler: str = "mkp"                # legacy alias: "mkp" (ours) |
    # "random" (baseline -> the "random_partition" scheduling policy)
    nid_threshold: float = 0.35
    seed: int = 0
    selection_policy: str | None = None       # stage-1 strategy, by
    # registry name (core.policy): "paper_greedy" | "dp" | "random" |
    # "score_prop" | anything registered. None = not set: an explicit
    # legacy ``method=`` wins, else the default ("paper_greedy")
    scheduling_policy: str | None = None      # stage-2 strategy:
    # "iid_subsets" | "random_partition" | "fair_ema" | registered.
    # None = not set: the legacy ``scheduler`` alias decides ("mkp" ->
    # "iid_subsets", "random" -> "random_partition"); an explicit name
    # always wins over the alias
    round_chunk: int = 1                  # rounds per trainer dispatch (>1 =
    # chunked rounds; requires a chunk-capable Trainer)
    admit_joiners: bool = True            # churn: admit clients registered
    # after stage 1 at the next PERIOD_CHECKPOINT, budget permitting
    overschedule_factor: float = 1.0      # straggler mitigation: dispatch
    # ceil(factor * n) clients per round (extras drawn from the task
    # pool by the task rng); the round still closes at the first n
    # arrivals. 1.0 = off. Only observable under an active FaultPlan.
    quorum_frac: float = 0.0              # minimum fraction of the
    # *scheduled* subset that must arrive for a round to commit (at
    # least one arrival is always required under a fault plan); a
    # missed quorum triggers the retry/backoff path
    collect_deadline: float = 0.0         # per-round arrival deadline in
    # FaultPlan latency units; 0 = none (close at the first-k arrivals)
    max_retries: int = 3                  # quorum-miss retries per round
    # (fresh subset redraw + exponential backoff) before the task
    # degrades to the terminal DEGRADED phase
    retry_backoff: float = 1.0            # initial backoff penalty (in
    # latency units) charged per retry, doubling each consecutive miss
    compression: str | None = None        # client-update codec spec
    # (repro_torch.fl.compression grammar: "int8" | "topk:F" | "topk:F+int8",
    # optional "@chunk=N"); None / "none" = uncompressed. Forwarded to
    # compression-aware trainers; recorded in format-4 checkpoints


@dataclasses.dataclass
class RoundEvent:
    """One completed FL round, as emitted by a TRAINING step."""
    period: int
    round_index: int
    subset: list[int]
    weights: np.ndarray
    nid: float
    metrics: dict


# Pre-redesign name for the same record (ServiceRunResult.rounds entries).
RoundLog = RoundEvent


@dataclasses.dataclass
class ServiceRunResult:
    pool: SelectionResult
    rounds: list[RoundEvent]
    schedules: list[ScheduleResult]
    reputation: dict[int, float]

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)


# ---------------------------------------------------------------------------
# Trainer protocol
# ---------------------------------------------------------------------------

@runtime_checkable
class Trainer(Protocol):
    """Explicit trainer contract (replaces ``hasattr("run_rounds")``).

    ``run_rounds(start_round, subsets, weights)`` runs
    ``len(subsets)`` consecutive FL rounds and returns one
    ``(returned_flags, q_values, metrics)`` tuple per round. A trainer
    that can fuse consecutive rounds into one device dispatch (e.g.
    ``fl.simulation.DeviceFLSim``) simply implements this over the whole
    chunk; a sequential trainer loops internally. Set the class
    attribute ``chunkable = False`` to force one-round chunks regardless
    of ``TaskRequest.round_chunk`` (the default is chunk-capable).

    A trainer may additionally implement the :class:`AsyncTrainer` pair
    (``dispatch_rounds`` / ``collect``) to let the service overlap its
    device work with other tasks; ``run_rounds`` alone is always enough
    (the lifecycle falls back to eager execution at dispatch time).
    """

    def run_rounds(self, start_round: int,
                   subsets: Sequence[Sequence[int]],
                   weights: Sequence[np.ndarray]
                   ) -> list[tuple[np.ndarray, np.ndarray, dict]]: ...


@runtime_checkable
class AsyncTrainer(Trainer, Protocol):
    """Optional asynchronous extension of :class:`Trainer`.

    ``dispatch_rounds(start_round, subsets, weights)`` *enqueues* the
    chunk and returns an opaque handle without blocking on the device
    (on the card: tensors whose kernels are queued, not finished);
    ``collect(handle)`` blocks, materializes, and returns exactly what
    ``run_rounds`` would have: one ``(returned_flags, q_values,
    metrics)`` tuple per round. The contract is
    ``collect(dispatch_rounds(*a)) == run_rounds(*a)`` bit-for-bit —
    ``fl.simulation.DeviceFLSim`` implements ``run_rounds`` as exactly
    that composition.

    Handles must tolerate interleaving: between a task's
    ``dispatch_rounds`` and its ``collect``, other trainers (other
    tasks) may dispatch and collect their own chunks.
    """

    def dispatch_rounds(self, start_round: int,
                        subsets: Sequence[Sequence[int]],
                        weights: Sequence[np.ndarray]) -> Any: ...

    def collect(self, handle: Any
                ) -> list[tuple[np.ndarray, np.ndarray, dict]]: ...


class single_round_adapter:
    """Wrap a legacy per-round callable ``fn(round, subset, weights)``
    into the :class:`Trainer` protocol. ``chunkable = False`` keeps the
    deprecated callback contract: exactly one round per dispatch."""

    chunkable = False

    def __init__(self, fn: Callable[[int, Sequence[int], np.ndarray], tuple]):
        self.fn = fn

    def run_rounds(self, start_round, subsets, weights):
        return [self.fn(start_round + j, subsets[j], weights[j])
                for j in range(len(subsets))]


def resolve_trainer(trainer) -> Trainer:
    """Coerce ``trainer`` into the protocol: real Trainers pass through,
    bare callables get wrapped in :class:`single_round_adapter`."""
    if isinstance(trainer, Trainer):
        return trainer
    if callable(trainer):
        return single_round_adapter(trainer)
    raise TypeError(f"trainer {trainer!r} is neither a Trainer "
                    f"(run_rounds) nor a per-round callable")


def _chunk_size(task: TaskRequest, trainer: Trainer) -> int:
    return max(1, int(task.round_chunk)) \
        if getattr(trainer, "chunkable", True) else 1


class InFlightError(RuntimeError):
    """Raised when an operation that needs a settled :class:`TaskState`
    (serialization, a fresh dispatch) meets an un-collected in-flight
    chunk. Call :func:`collect` first, or ``save_state(..., flush=True)``.
    The message names the task id and the pending round range so the
    offending tenant is identifiable in multi-task sweeps."""


@dataclasses.dataclass
class PendingChunk:
    """An in-flight TRAINING chunk: everything :func:`collect` needs to
    turn the trainer's handle into :class:`RoundEvent` s.

    ``handle`` is whatever ``AsyncTrainer.dispatch_rounds`` returned
    (unmaterialized device arrays), or — for a plain sync
    :class:`Trainer` — the already-computed ``run_rounds`` result list
    (``sync=True``). Transient by design: never serialized
    (``TaskState.to_arrays`` refuses while one is pending).
    """

    trainer: Trainer
    handle: Any
    chunk: list[list[int]]          # the dispatched subsets
    ws: list[np.ndarray]            # their FedAvg weights
    t: int                          # subset_index at dispatch time
    stop_fn: Callable[[dict], bool] | None
    sync: bool                      # handle already holds results
    arrivals: list[np.ndarray] | None = None   # fault mode: per-round
    # bool arrival masks over the dispatched members (first-k-collect)
    close_times: list[float] | None = None     # fault mode: per-round
    # simulated close times (-> metrics["round_latency"])
    penalty: float = 0.0            # accumulated retry latency charged
    # to this chunk's first committed round
    pool: Any = None                # ClientPoolState ref, for unpinning
    pinned: list[int] | None = None  # ids pinned against deregister
    # while this chunk is in flight (core.pool deferred-dereg guard)


# ---------------------------------------------------------------------------
# Task state
# ---------------------------------------------------------------------------

class TaskPhase(enum.IntEnum):
    INTAKE = 0             # submitted, stage 1 not yet run
    POOL_SELECTED = 1      # pool known; next step schedules a period
    SCHEDULED = 2          # period schedule pending, no round trained yet
    TRAINING = 3           # mid-period: >=1 chunk dispatched
    PERIOD_CHECKPOINT = 4  # period over; next step updates the pool
    DONE = 5
    INFEASIBLE = 6
    DEGRADED = 7           # graceful degradation: a round missed quorum
    # max_retries times (or the scheduler evicted a wedged in-flight
    # chunk) — the task is parked terminal instead of wedging the
    # service; its accumulated rounds/results stay available

    @property
    def terminal(self) -> bool:
        return self in (TaskPhase.DONE, TaskPhase.INFEASIBLE,
                        TaskPhase.DEGRADED)


@dataclasses.dataclass
class TaskState:
    """Everything ``run_task`` kept in locals, made explicit.

    Advanced exclusively by :func:`step`; serialized by
    :meth:`to_arrays` / :meth:`from_arrays` (control state only — the
    accumulated ``rounds``/``schedules`` histories are *event streams*,
    already delivered to the caller, and are not checkpointed; a
    restored task reproduces the remaining rounds exactly).
    """

    task: TaskRequest
    phase: TaskPhase = TaskPhase.INTAKE
    rng: np.random.Generator | None = None     # created at construction
    pool_selected: SelectionResult | None = None
    tracker: ReputationTracker | None = None
    pool: set[int] = dataclasses.field(default_factory=set)
    admitted: list[int] = dataclasses.field(default_factory=list)
    admitted_cost: float = 0.0
    schedule: ScheduleResult | None = None     # pending period schedule
    subset_index: int = 0                      # cursor into schedule.subsets
    period: int = 0
    global_round: int = 0
    stop: bool = False                         # stop_fn/max_rounds fired
    pool_watermark: int = 0                    # pool_state.reg_counter at
    # the last joiner scan (registration *events*, not row count, so
    # tombstone-reactivating rejoins are seen too)
    rounds: list[RoundEvent] = dataclasses.field(default_factory=list)
    schedules: list[ScheduleResult] = dataclasses.field(default_factory=list)
    pending: PendingChunk | None = None        # in-flight dispatched chunk
    # (transient — set by dispatch(), cleared by collect(), never
    # serialized; to_arrays() refuses while one is outstanding)
    policy_state: dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)                  # scheduling-policy cursor
    # arrays (e.g. fair_ema participation EMAs), owned by the task and
    # serialized with it — string keys, numpy-array values only
    retry_count: int = 0                       # consecutive quorum misses
    # on the round at subset_index (fault mode; reset on a commit)
    retry_latency: float = 0.0                 # accumulated close-time +
    # backoff penalty, charged to the next committed round's latency
    task_id: int | None = None                 # scheduler-assigned tenant
    # id (ServiceScheduler.submit/adopt); used in error messages
    trainer_state: dict = dataclasses.field(default_factory=dict)
    # flat {path: numpy array} export of the trainer's server state
    # (params + optimizer moments — checkpoint.tree_to_arrays form),
    # attached by attach_trainer_state / save_state(trainer=...) and
    # serialized with the task (format 4) so a restored run resumes the
    # model exactly; empty when the trainer has no export_state()

    def __post_init__(self):
        if self.rng is None:
            self.rng = np.random.default_rng(self.task.seed)

    @property
    def eligible(self) -> set[int]:
        """Clients allowed back into the pool after suspension: the
        stage-1 selection plus churn admissions."""
        sel = self.pool_selected.selected if self.pool_selected else []
        return set(sel) | set(self.admitted)

    def _inflight_desc(self) -> str:
        """Human-readable identity of the in-flight chunk, for
        :class:`InFlightError` messages (which task, which rounds)."""
        tid = "unassigned" if self.task_id is None else str(self.task_id)
        if self.pending is None:
            return f"task id {tid}, period {self.period}"
        lo = self.global_round
        hi = lo + len(self.pending.chunk) - 1
        rounds = str(lo) if hi == lo else f"{lo}..{hi}"
        return (f"task id {tid}, period {self.period}, "
                f"pending rounds {rounds}")

    # -- serialization -------------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        """Flat ``{key: numpy array}`` form of the control state, ready
        for ``repro_torch.checkpoint.save`` (msgpack; no pickle anywhere).

        Raises :class:`InFlightError` while a dispatched chunk is
        pending — device handles are not serializable, so an in-flight
        state must be settled first (``lifecycle.collect(state)``, or
        ``save_state(..., flush=True)`` which does it for you).
        """
        if self.pending is not None:
            raise InFlightError(
                f"TaskState ({self._inflight_desc()}) has an in-flight "
                f"dispatched chunk; call lifecycle.collect(state) (or "
                f"save_state(..., flush=True)) before serializing")
        a: dict[str, np.ndarray] = {}
        t = self.task
        a["format"] = np.array([_STATE_FORMAT], dtype=np.int64)
        a["meta"] = np.array(
            [int(self.phase), self.period, self.subset_index,
             self.global_round, int(self.stop), self.pool_watermark,
             int(self.schedule is not None),
             int(self.pool_selected is not None),
             int(self.tracker is not None)], dtype=np.int64)
        a["task/floats"] = np.array(
            [t.budget, t.rep_threshold, t.nid_threshold,
             t.overschedule_factor, t.quorum_frac, t.collect_deadline,
             t.retry_backoff], dtype=np.float64)
        a["task/ints"] = np.array(
            [t.n_star, t.subset_size, t.subset_delta, t.x_star,
             t.max_periods,
             0 if t.max_rounds is None else 1,
             0 if t.max_rounds is None else int(t.max_rounds),
             t.suspension_periods, t.seed, t.round_chunk,
             int(t.admit_joiners), t.max_retries], dtype=np.int64)
        a["retry"] = np.array([float(self.retry_count),
                               self.retry_latency], dtype=np.float64)
        a["task_id"] = np.array(
            [int(self.task_id is not None),
             0 if self.task_id is None else int(self.task_id)],
            dtype=np.int64)
        a["task/scheduler"] = _encode_str(t.scheduler)
        # None (policy not set) encodes as the empty string — no
        # registered policy can have an empty name
        a["task/selection_policy"] = _encode_str(t.selection_policy or "")
        a["task/scheduling_policy"] = _encode_str(t.scheduling_policy or "")
        # likewise: None (no codec) encodes as the empty string
        a["task/compression"] = _encode_str(t.compression or "")
        for k, v in self.trainer_state.items():
            a[f"trn/{k}"] = np.asarray(v)
        a["task/thresholds"] = (np.zeros(0) if t.thresholds is None
                                else np.asarray(t.thresholds, np.float64))
        a["task/has_thresholds"] = np.array(
            [t.thresholds is not None], dtype=np.int64)
        a["rng"] = _encode_rng(self.rng)
        for k, v in self.policy_state.items():
            a[f"pol/{k}"] = np.asarray(v)
        a["pool/ids"] = np.array(sorted(self.pool), dtype=np.int64)
        a["admitted/ids"] = np.array(self.admitted, dtype=np.int64)
        a["admitted/cost"] = np.array([self.admitted_cost], dtype=np.float64)
        if self.pool_selected is not None:
            s = self.pool_selected
            a["sel/ids"] = np.array(s.selected, dtype=np.int64)
            a["sel/totals"] = np.array(
                [s.total_score, s.total_cost, float(s.feasible)],
                dtype=np.float64)
            a["sel/note"] = _encode_str(s.note)
        if self.tracker is not None:
            for k, v in self.tracker.to_arrays().items():
                a[f"rep/{k}"] = v
        if self.schedule is not None:
            for k, v in _encode_schedule(self.schedule).items():
                a[f"sched/{k}"] = v
        return a

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, Any]) -> "TaskState":
        a = {k: np.asarray(v) for k, v in arrays.items()}
        fmt = int(a["format"][0])
        if fmt not in _STATE_FORMATS:
            raise ValueError(f"unsupported TaskState format {fmt}")
        meta = a["meta"].astype(np.int64)
        tf = a["task/floats"].astype(np.float64)
        ti = a["task/ints"].astype(np.int64)
        task = TaskRequest(
            budget=float(tf[0]), n_star=int(ti[0]), subset_size=int(ti[1]),
            subset_delta=int(ti[2]), x_star=int(ti[3]),
            max_periods=int(ti[4]),
            max_rounds=int(ti[6]) if ti[5] else None,
            rep_threshold=float(tf[1]), suspension_periods=int(ti[7]),
            scheduler=_decode_str(a["task/scheduler"]),
            nid_threshold=float(tf[2]), seed=int(ti[8]),
            round_chunk=int(ti[9]), admit_joiners=bool(ti[10]),
            thresholds=(a["task/thresholds"].astype(np.float64)
                        if int(a["task/has_thresholds"][0]) else None))
        if fmt >= 2:
            task.selection_policy = \
                _decode_str(a["task/selection_policy"]) or None
            task.scheduling_policy = \
                _decode_str(a["task/scheduling_policy"]) or None
        if fmt >= 3:
            task.overschedule_factor = float(tf[3])
            task.quorum_frac = float(tf[4])
            task.collect_deadline = float(tf[5])
            task.retry_backoff = float(tf[6])
            task.max_retries = int(ti[11])
        if fmt >= 4:
            task.compression = _decode_str(a["task/compression"]) or None
        state = cls(task=task, phase=TaskPhase(int(meta[0])),
                    rng=_decode_rng(a["rng"]))
        if fmt >= 4:
            state.trainer_state = {k[len("trn/"):]: v for k, v in a.items()
                                   if k.startswith("trn/")}
        if fmt >= 3:
            retry = a["retry"].astype(np.float64)
            state.retry_count = int(retry[0])
            state.retry_latency = float(retry[1])
            tid = a["task_id"].astype(np.int64)
            state.task_id = int(tid[1]) if int(tid[0]) else None
        state.policy_state = {k[len("pol/"):]: v for k, v in a.items()
                              if k.startswith("pol/")}
        state.period = int(meta[1])
        state.subset_index = int(meta[2])
        state.global_round = int(meta[3])
        state.stop = bool(meta[4])
        state.pool_watermark = int(meta[5])
        state.pool = {int(c) for c in a["pool/ids"]}
        state.admitted = [int(c) for c in a["admitted/ids"]]
        state.admitted_cost = float(a["admitted/cost"][0])
        if int(meta[7]):
            tot = a["sel/totals"].astype(np.float64)
            state.pool_selected = SelectionResult(
                [int(c) for c in a["sel/ids"]], float(tot[0]), float(tot[1]),
                feasible=bool(tot[2]), note=_decode_str(a["sel/note"]))
        if int(meta[8]):
            state.tracker = ReputationTracker.from_arrays(
                {k[len("rep/"):]: v for k, v in a.items()
                 if k.startswith("rep/")})
        if int(meta[6]):
            state.schedule = _decode_schedule(
                {k[len("sched/"):]: v for k, v in a.items()
                 if k.startswith("sched/")})
            # the pending schedule was appended to the history when it
            # was generated; keep the resumed result self-consistent
            state.schedules.append(state.schedule)
        return state


# Alias naming the explicit service-side state.
ServiceState = TaskState


# -- serialization helpers ---------------------------------------------------

def _encode_str(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8).copy()


def _decode_str(a: np.ndarray) -> str:
    return bytes(np.asarray(a, dtype=np.uint8).tolist()).decode("utf-8")


def _encode_rng(rng: np.random.Generator) -> np.ndarray:
    st = rng.bit_generator.state
    if st.get("bit_generator") != "PCG64":
        raise ValueError("TaskState serialization requires the default "
                         "PCG64 bit generator (np.random.default_rng)")
    M = (1 << 64) - 1
    s, inc = st["state"]["state"], st["state"]["inc"]
    return np.array([s & M, (s >> 64) & M, inc & M, (inc >> 64) & M,
                     st["has_uint32"], st["uinteger"]], dtype=np.uint64)


def _decode_rng(a: np.ndarray) -> np.random.Generator:
    a = np.asarray(a, dtype=np.uint64)
    rng = np.random.default_rng(0)
    st = rng.bit_generator.state
    st["state"]["state"] = int(a[0]) | (int(a[1]) << 64)
    st["state"]["inc"] = int(a[2]) | (int(a[3]) << 64)
    st["has_uint32"] = int(a[4])
    st["uinteger"] = int(a[5])
    rng.bit_generator.state = st
    return rng


def _encode_schedule(s: ScheduleResult) -> dict[str, np.ndarray]:
    P = len(s.subsets)
    L = max((len(x) for x in s.subsets), default=0)
    subs = np.full((P, L), -1, dtype=np.int64)
    lens = np.zeros(P, dtype=np.int64)
    for i, x in enumerate(s.subsets):
        subs[i, : len(x)] = x
        lens[i] = len(x)
    cids = np.array(list(s.counts.keys()), dtype=np.int64)
    cvals = np.array([s.counts[int(c)] for c in cids], dtype=np.int64)
    return {"subsets": subs, "lens": lens,
            "nids": np.asarray(s.nids, dtype=np.float64),
            "count_ids": cids, "count_vals": cvals,
            "capacities": np.asarray(s.capacities, dtype=np.float64)}


def _decode_schedule(a: Mapping[str, np.ndarray]) -> ScheduleResult:
    subs = np.asarray(a["subsets"], dtype=np.int64)
    lens = np.asarray(a["lens"], dtype=np.int64)
    if subs.size == 0:
        subs = subs.reshape(lens.size, 0)
    subsets = [[int(v) for v in subs[i, : lens[i]]]
               for i in range(lens.size)]
    counts = {int(c): int(v) for c, v in
              zip(np.asarray(a["count_ids"]), np.asarray(a["count_vals"]))}
    return ScheduleResult(subsets,
                          [float(x) for x in np.asarray(a["nids"])],
                          counts,
                          np.asarray(a["capacities"], dtype=np.float64))


def attach_trainer_state(state: TaskState, trainer) -> TaskState:
    """Snapshot the trainer's server state into
    ``state.trainer_state`` (format-4 checkpoints carry it).

    Uses the trainer's ``export_state()`` — a flat
    ``{path: numpy array}`` mapping (``checkpoint.tree_to_arrays``
    form) covering params and any server-optimizer moments. Trainers
    without the hook leave ``trainer_state`` untouched (control-plane
    state still checkpoints; the caller owns the model). Returns
    ``state`` for chaining.
    """
    export = getattr(trainer, "export_state", None)
    if export is not None:
        state.trainer_state = dict(export())
    return state


def restore_trainer_state(state: TaskState, trainer) -> bool:
    """Load ``state.trainer_state`` back into a fresh trainer via its
    ``import_state(arrays)`` hook. Returns ``True`` if arrays were
    applied, ``False`` when the checkpoint carried none (pre-format-4
    payloads, or a trainer that never exported)."""
    if not state.trainer_state:
        return False
    trainer.import_state(state.trainer_state)
    return True


def save_state(path: str, state: TaskState, flush: bool = False,
               trainer=None) -> list[RoundEvent]:
    """Serialize ``state`` through the repo checkpoint path (msgpack,
    zstd when available).

    A state captured between :func:`dispatch` and :func:`collect` holds
    unmaterialized device arrays and cannot be serialized as-is:
    ``flush=False`` (default) raises :class:`InFlightError`;
    ``flush=True`` collects the pending chunk first (blocking on the
    device) and returns its :class:`RoundEvent` s — they are also
    appended to ``state.rounds``, so a caller that streams events should
    take them from the return value exactly once. Returns ``[]`` when
    nothing was in flight.

    ``trainer``: optionally attach the trainer's exported server state
    (:func:`attach_trainer_state`) before serializing, so the single
    checkpoint file carries control plane *and* model; restore with
    :func:`load_state` + :func:`restore_trainer_state`.
    """
    raise NotImplementedError(
        "checkpoint files are not ported yet: ROADMAP.md Queue 1 item 4")


def load_state(path: str) -> TaskState:
    """Inverse of :func:`save_state` (structure-free restore)."""
    raise NotImplementedError(
        "checkpoint files are not ported yet: ROADMAP.md Queue 1 item 4")


# ---------------------------------------------------------------------------
# Transition functions
# ---------------------------------------------------------------------------

def submit(provider, task: TaskRequest,
           method: str | None = None) -> TaskState:
    """Task intake + stage 1 (paper Eq. 8): select the task's client
    pool from the provider's shared registry under the budget,
    ``n_star`` and per-criterion thresholds, and return the resulting
    :class:`TaskState` — POOL_SELECTED on success, INFEASIBLE when the
    budget/thresholds cannot seat ``n_star`` clients (then the state is
    terminal and :func:`step` is a no-op).

    ``provider`` is an ``FLServiceProvider``. Stage 1 runs the task's
    registered selection policy (``task.selection_policy``, default
    ``paper_greedy`` — see :mod:`repro_torch.core.policy`); an explicitly
    passed legacy ``method`` ("greedy" | "dp" | "random") always wins
    over the field. For many concurrent tasks, prefer
    ``ServiceScheduler.submit`` — its intake batches all queued tasks
    through the policies' batched path (one vectorized knapsack sweep
    for the default).
    """
    state = TaskState(task=task)
    sel = provider.select_pool(task, method=method, rng=state.rng)
    return apply_pool_selection(provider, state, sel)


def apply_pool_selection(provider, state: TaskState,
                         sel: SelectionResult) -> TaskState:
    """Attach a stage-1 result to an INTAKE state (used by
    :func:`submit` and by the batched ``ServiceScheduler`` intake)."""
    if state.phase != TaskPhase.INTAKE:
        raise ValueError(f"stage 1 already applied (phase={state.phase.name})")
    state.pool_selected = sel
    if not sel.feasible:
        state.phase = TaskPhase.INFEASIBLE
        return state
    state.pool = set(sel.selected)
    state.tracker = ReputationTracker(
        sel.selected, suspension_periods=state.task.suspension_periods,
        rep_threshold=state.task.rep_threshold)
    state.pool_watermark = provider.pool_state.reg_counter
    state.phase = TaskPhase.POOL_SELECTED
    return state


def step(provider, state: TaskState, trainer,
         availability_fn: Callable[[int, int], bool] | None = None,
         stop_fn: Callable[[dict], bool] | None = None,
         ) -> tuple[TaskState, list[RoundEvent]]:
    """Advance the task by exactly one transition.

    POOL_SELECTED steps generate the next period's schedule (or finish
    the task when a loop guard fires); SCHEDULED/TRAINING steps dispatch
    one round chunk to ``trainer`` and emit the resulting
    :class:`RoundEvent` s; PERIOD_CHECKPOINT steps run the reputation
    pool update, churn admission, and either loop or finish. Terminal
    states are no-ops.

    ``trainer`` may be a :class:`Trainer` or a legacy per-round callable
    (wrapped via :func:`single_round_adapter`); ``availability_fn`` /
    ``stop_fn`` keep their ``run_task`` semantics. The state is mutated
    in place and also returned.

    A SCHEDULED/TRAINING step is exactly :func:`dispatch` followed by
    :func:`collect`; stepping a state that already has an in-flight
    chunk simply collects it (finishing the half-done transition).
    """
    if state.pending is not None:
        return collect(state)
    if state.phase.terminal:
        return state, []
    if state.phase == TaskPhase.INTAKE:
        raise ValueError("cannot step an INTAKE state: run submit() or a "
                         "ServiceScheduler intake first")
    if state.phase == TaskPhase.POOL_SELECTED:
        return _schedule_next_period(provider, state), []
    if state.phase in (TaskPhase.SCHEDULED, TaskPhase.TRAINING):
        dispatch(provider, state, trainer, stop_fn=stop_fn)
        return collect(state)
    # PERIOD_CHECKPOINT
    return _period_checkpoint(provider, state, availability_fn), []


def dispatch(provider, state: TaskState, trainer,
             stop_fn: Callable[[dict], bool] | None = None) -> TaskState:
    """Asynchronous half of a TRAINING transition: *enqueue* the next
    round chunk without waiting for its results.

    Valid on SCHEDULED/TRAINING states only (terminal states are
    no-ops). If the period is already exhausted (or ``max_rounds`` /
    ``stop`` fired) this performs the host-side phase advance to
    PERIOD_CHECKPOINT and leaves nothing in flight; otherwise it
    computes the chunk's subsets/weights on the host, hands them to the
    trainer — ``AsyncTrainer.dispatch_rounds`` enqueues and returns
    immediately; a plain :class:`Trainer` runs eagerly as a sync
    fallback — and parks the handle on ``state.pending``.

    Until :func:`collect` settles the chunk, the state is *in flight*:
    ``to_arrays``/``save_state`` refuse it and a second ``dispatch``
    raises :class:`InFlightError`. :class:`ServiceScheduler` uses this
    split to enqueue every runnable task's chunk back-to-back, so task
    B's device work overlaps task A's (asynchronous launches), then
    collects in completion order.
    """
    if state.pending is not None:
        raise InFlightError(
            f"a chunk is already in flight ({state._inflight_desc()}); "
            f"collect() it before dispatching another")
    if state.phase.terminal:
        return state
    if state.phase not in (TaskPhase.SCHEDULED, TaskPhase.TRAINING):
        raise ValueError(f"dispatch needs a SCHEDULED/TRAINING state, "
                         f"got {state.phase.name}")
    return _dispatch_chunk(provider, state, resolve_trainer(trainer),
                           stop_fn)


def collect(state: TaskState) -> tuple[TaskState, list[RoundEvent]]:
    """Blocking half of a TRAINING transition: materialize the in-flight
    chunk into :class:`RoundEvent` s and advance the phase.

    Needs no provider — everything host-side was captured at
    :func:`dispatch` time. Settles reputation bookkeeping, appends the
    events to ``state.rounds``, advances ``subset_index`` /
    ``global_round``, runs ``stop_fn`` per round, and moves the phase to
    TRAINING or PERIOD_CHECKPOINT exactly as the blocking step did.
    A state with nothing in flight is a no-op returning ``[]``.
    """
    p = state.pending
    if p is None:
        return state, []
    results = p.handle if p.sync else p.trainer.collect(p.handle)
    state.pending = None
    return _settle_chunk(state, p, results)


def drain(provider, state: TaskState, trainer,
          availability_fn: Callable[[int, int], bool] | None = None,
          stop_fn: Callable[[dict], bool] | None = None,
          max_steps: int | None = None,
          ) -> tuple[TaskState, list[RoundEvent]]:
    """Step until the task reaches DONE/INFEASIBLE (the convenience
    loop ``run_task`` shims over). Returns the final state and every
    :class:`RoundEvent` produced along the way; ``max_steps`` bounds
    the loop for callers that want to pause mid-task (the state can be
    resumed by another ``drain``/``step``, checkpointed via
    :func:`save_state`, or handed to ``ServiceScheduler.adopt``)."""
    events: list[RoundEvent] = []
    steps = 0
    while not state.phase.terminal:
        state, ev = step(provider, state, trainer,
                         availability_fn=availability_fn, stop_fn=stop_fn)
        events.extend(ev)
        steps += 1
        if max_steps is not None and steps >= max_steps:
            break
    return state, events


def as_run_result(state: TaskState) -> ServiceRunResult:
    """The accumulated ``ServiceRunResult`` view of a task state."""
    rep = state.tracker.scores() if state.tracker is not None else {}
    pool_sel = state.pool_selected if state.pool_selected is not None \
        else SelectionResult([], 0.0, 0.0, feasible=False, note="no stage 1")
    return ServiceRunResult(pool_sel, state.rounds, state.schedules, rep)


# -- internal transitions ----------------------------------------------------

def _drop_deregistered(provider, state: TaskState) -> None:
    """Remove members that churned out of the shared pool from the
    task's pool (used at both churn windows: before a schedule draw and
    at the period checkpoint)."""
    if not state.pool:
        return
    ids = np.array(sorted(state.pool), dtype=np.int64)
    state.pool -= {int(c)
                   for c in ids[~provider.pool_state.is_registered(ids)]}


def _schedule_next_period(provider, state: TaskState) -> TaskState:
    task = state.task
    # churn can strike between the last checkpoint and this step
    # (including right after submit): drop deregistered members before
    # drawing the schedule
    _drop_deregistered(provider, state)
    if (not state.pool or state.period >= task.max_periods
            or (task.max_rounds is not None
                and state.global_round >= task.max_rounds)):
        state.phase = TaskPhase.DONE
        return state
    # publish the task's timing observability columns before drawing the
    # schedule: the reputation tracker's aligned timing arrays plus the
    # rolling round-latency window maintained by _settle_chunk. They live
    # in policy_state (string keys -> numpy arrays) so deadline/straggler
    # -aware scheduling policies can react mid-task and the columns ride
    # checkpoints; policies that don't read them are unaffected.
    state.policy_state["obs/ids"] = state.tracker.client_ids.copy()
    state.policy_state["obs/timeouts"] = state.tracker.timeout_failures
    state.policy_state["obs/rounds"] = state.tracker.round_counts
    state.schedule = provider.schedule_period(sorted(state.pool), task,
                                              state.rng,
                                              policy_state=state.policy_state)
    state.schedules.append(state.schedule)
    state.subset_index = 0
    state.stop = False
    state.phase = TaskPhase.SCHEDULED
    return state


def _fault_plan(trainer):
    """The trainer's attached :class:`~repro_torch.core.faults.FaultPlan`, or
    ``None`` when fault injection is off. An inactive plan (all rates
    zero) is treated as absent, so the unmodified no-fault code path —
    and its bit-exact results — is taken whenever nothing can fail."""
    plan = getattr(trainer, "fault_plan", None)
    if plan is None or not plan.active:
        return None
    return plan


def _redraw_subset(state: TaskState, n: int) -> list[int]:
    """Fresh subset draw for a quorum-miss retry: uniform n-of-pool from
    the task's own rng (checkpointed, so a mid-backoff restore redraws
    identically)."""
    pool = np.array(sorted(state.pool), dtype=np.int64)
    k = min(int(n), pool.size)
    picks = state.rng.choice(pool.size, size=k, replace=False)
    return [int(c) for c in pool[np.sort(picks)]]


def _eval_round(state: TaskState, plan, base: Sequence[int], rnd: int):
    """Overschedule ``base`` and evaluate the round's arrival outcome
    under the fault plan. Deterministic given (plan, members, round), so
    dispatch can pre-compute which scheduled clients will report by the
    close and mask the rest on device before any training runs."""
    task = state.task
    n = len(base)
    members = list(base)
    want = int(np.ceil(n * max(1.0, task.overschedule_factor)))
    if want > n:
        cand = np.array(sorted(state.pool - set(members)), dtype=np.int64)
        if cand.size:
            k = min(want - n, cand.size)
            picks = state.rng.choice(cand.size, size=k, replace=False)
            members += [int(c) for c in cand[np.sort(picks)]]
    quorum_k = max(1, int(np.ceil(task.quorum_frac * n)))
    out = plan.round_outcome(members, rnd, task.collect_deadline,
                             target_k=n, quorum_k=quorum_k)
    return members, out


def _plan_chunk(provider, state: TaskState, plan, t: int, limit: int):
    """Evaluate the prospective chunk's arrivals round by round, stopping
    before the first quorum miss. Returns ``(chunk, arrivals,
    close_times, miss)`` where ``miss`` is the failing round's
    :class:`~repro_torch.core.faults.RoundOutcome` (or ``None``). Non-arrived
    members are charged a timing failure whether or not the round
    commits — chronic stragglers must not hide behind retries."""
    sched = state.schedule
    chunk: list[list[int]] = []
    arrivals: list[np.ndarray] = []
    closes: list[float] = []
    for j in range(min(limit, len(sched.subsets) - t)):
        base = sched.subsets[t + j]
        if j == 0 and state.retry_count > 0:
            base = _redraw_subset(state, len(base))
        members, out = _eval_round(state, plan, base,
                                   state.global_round + j)
        rows = provider.pool_state.positions(members,
                                             include_deregistered=True)
        provider.pool_state.note_timing(rows, rows[~out.arrival])
        for i, cid in enumerate(members):
            if not out.arrival[i]:
                state.tracker.record_timeout(cid)
        if not out.quorum_met:
            return chunk, arrivals, closes, out
        chunk.append(members)
        arrivals.append(out.arrival)
        closes.append(out.close_time)
    return chunk, arrivals, closes, None


def _quorum_miss(state: TaskState, out) -> TaskState:
    """A round's arrivals missed quorum before anything was dispatched:
    charge the close time plus an exponential backoff to the task's
    latency account, then either leave the state in TRAINING (the next
    dispatch retries against a fresh subset draw) or — past
    ``max_retries`` — degrade the task to the terminal DEGRADED phase
    rather than wedging the service."""
    task = state.task
    state.retry_count += 1
    backoff = task.retry_backoff * (2.0 ** (state.retry_count - 1))
    state.retry_latency += out.close_time + backoff
    if state.retry_count > task.max_retries:
        state.phase = TaskPhase.DEGRADED
    return state


def _dispatch_chunk(provider, state: TaskState, trainer: Trainer,
                    stop_fn) -> TaskState:
    """Host half of the TRAINING transition: pick the chunk, compute its
    weights, hand it to the trainer, park the handle on ``pending``.

    Under an active :class:`~repro_torch.core.faults.FaultPlan` on the trainer
    the chunk is first *arrival-evaluated* (:func:`_plan_chunk`):
    subsets are over-scheduled per ``task.overschedule_factor``, each
    round closes at its first-k arrivals / deadline, a quorum-missing
    round truncates the chunk (and, when it is the first round, routes
    through the retry/backoff path leaving nothing in flight), and the
    arrival masks ride along so the device (or :func:`_settle_chunk`)
    masks non-reporting clients out of the aggregate."""
    task, sched = state.task, state.schedule
    t = state.subset_index
    if sched is None or t >= len(sched.subsets) or state.stop:
        state.phase = TaskPhase.PERIOD_CHECKPOINT   # defensive guard
        return state
    limit = _chunk_size(task, trainer)
    if task.max_rounds is not None:
        remaining = task.max_rounds - state.global_round
        if remaining <= 0:
            state.stop = True
            state.phase = TaskPhase.PERIOD_CHECKPOINT
            return state
        limit = min(limit, remaining)
    plan = _fault_plan(trainer)
    arrivals = close_times = None
    penalty = 0.0
    if plan is None:
        chunk = sched.subsets[t: t + limit]
    else:
        chunk, arrivals, close_times, miss = _plan_chunk(
            provider, state, plan, t, limit)
        if not chunk:                   # first round missed quorum
            return _quorum_miss(state, miss)
        penalty, state.retry_latency = state.retry_latency, 0.0
        state.retry_count = 0
    data_sizes = provider.pool_state.data_sizes()
    ws = []
    for subset in chunk:
        # include_deregistered: a client churned out mid-period keeps
        # training this period's schedule against its (still resident)
        # tombstoned row; the next PERIOD_CHECKPOINT drops it.
        rows = provider.pool_state.positions(subset,
                                             include_deregistered=True)
        sizes = data_sizes[rows]
        ws.append(sizes / np.maximum(sizes.sum(), 1e-12))
    pinned = sorted({int(c) for subset in chunk for c in subset})
    provider.pool_state.pin(pinned)
    aware = arrivals is not None and getattr(trainer, "accepts_arrivals",
                                             False)
    if isinstance(trainer, AsyncTrainer):
        if aware:
            handle = trainer.dispatch_rounds(state.global_round, chunk, ws,
                                             arrivals=arrivals)
        else:
            handle = trainer.dispatch_rounds(state.global_round, chunk, ws)
        sync = False
    else:                                           # eager sync fallback
        if aware:
            handle = trainer.run_rounds(state.global_round, chunk, ws,
                                        arrivals=arrivals)
        else:
            handle = trainer.run_rounds(state.global_round, chunk, ws)
        sync = True
    state.pending = PendingChunk(trainer, handle, chunk, ws, t, stop_fn,
                                 sync, arrivals=arrivals,
                                 close_times=close_times, penalty=penalty,
                                 pool=provider.pool_state, pinned=pinned)
    state.phase = TaskPhase.TRAINING                # mid-period, in flight
    return state


def _settle_chunk(state: TaskState, p: PendingChunk, results
                  ) -> tuple[TaskState, list[RoundEvent]]:
    """Bookkeeping half of the TRAINING transition, shared by the
    blocking step and the overlapped collect path.

    When the chunk was dispatched under a fault plan (``p.arrivals``),
    clients that missed the round's close are masked out of ``returned``
    and ``q_vals`` before reputation bookkeeping (their timing failure
    was already charged at dispatch), and each round's metrics gain its
    simulated ``round_latency`` (close time, plus any retry backoff
    carried over from preceding quorum misses)."""
    if p.pinned is not None and p.pool is not None:
        p.pool.unpin(p.pinned)
    sched, t = state.schedule, p.t
    penalty = p.penalty
    events: list[RoundEvent] = []
    for j, (returned, q_vals, metrics) in enumerate(results):
        subset = p.chunk[j]
        if p.arrivals is not None:
            arr = np.asarray(p.arrivals[j], dtype=bool)
            returned = np.asarray(returned, dtype=bool) & arr
            q_vals = np.where(arr, np.asarray(q_vals, dtype=np.float64),
                              0.0)
            metrics = dict(metrics)
            metrics["round_latency"] = p.close_times[j] + penalty
            metrics["n_scheduled"] = len(subset)
            metrics["n_arrived"] = int(arr.sum())
            # rolling latency window for deadline-aware scheduling
            # (policy_state -> checkpointed; absent on the no-fault path)
            lat = np.append(
                state.policy_state.get("obs/latency",
                                       np.zeros(0, dtype=np.float64)),
                metrics["round_latency"])
            state.policy_state["obs/latency"] = lat[-_OBS_LATENCY_WINDOW:]
            if penalty:
                metrics["retry_penalty"] = penalty
            penalty = 0.0
        for i, cid in enumerate(subset):
            state.tracker.record_round(cid, bool(returned[i]),
                                       q_value=float(q_vals[i]))
        ev = RoundEvent(state.period, state.global_round, list(subset),
                        p.ws[j], sched.nids[t + j], metrics)
        state.rounds.append(ev)
        events.append(ev)
        state.global_round += 1
        if p.stop_fn is not None and p.stop_fn(metrics):
            state.stop = True
            break
    state.subset_index = t + len(p.chunk)
    state.phase = TaskPhase.TRAINING
    if state.stop or state.subset_index >= len(sched.subsets):
        state.phase = TaskPhase.PERIOD_CHECKPOINT
    return state, events


def _period_checkpoint(provider, state: TaskState,
                       availability_fn) -> TaskState:
    avail = {cid: (availability_fn(cid, state.period + 1)
                   if availability_fn else True)
             for cid in state.tracker.records}
    state.pool = state.tracker.update_pool(state.pool, avail) \
        & state.eligible
    state.schedule = None
    state.period += 1
    if state.stop:
        state.phase = TaskPhase.DONE
        return state
    _apply_churn(provider, state)
    state.phase = TaskPhase.POOL_SELECTED
    return state


def _apply_churn(provider, state: TaskState) -> None:
    """Between periods, sync the task with pool churn: drop deregistered
    clients, then admit qualifying joiners while the stage-1 budget
    lasts — an incremental stage 1, not a re-run. Rows are found by
    their registration-event stamp (``reg_seq``), so a rejoin that
    reactivated a tombstoned row below the old row-count is seen too.

    Admission routes through the task's *resolved selection policy*
    (optional ``select_joiners`` hook, see ``core.policy``): a ``dp``
    task admits joiners with the exact knapsack, a ``score_prop`` task
    samples them, etc. Policies without the hook — and the default
    ``paper_greedy`` — use the skip-unaffordable score/cost-ratio
    greedy, bit-identical to the pre-policy hard-coded rule. Rejoining
    clients the task already tracks (``state.eligible``) are filtered
    out *before* the policy sees the candidates: their seat is already
    paid for, and this checkpoint's ``update_pool ∩ eligible`` already
    decided their membership — no second charge."""
    from .policy import resolve_selection_policy
    from .selection import select_greedy
    ps = provider.pool_state
    _drop_deregistered(provider, state)
    task = state.task
    if not task.admit_joiners:
        state.pool_watermark = ps.reg_counter
        return
    if ps.reg_counter <= state.pool_watermark:
        return
    rows = np.flatnonzero(ps.reg_seq > state.pool_watermark)
    state.pool_watermark = ps.reg_counter
    ok = ps.threshold_mask(task.thresholds)[rows]
    rows = rows[ok]
    if rows.size:
        eligible = state.eligible
        free = np.fromiter((int(c) not in eligible
                            for c in ps.client_ids[rows]),
                           dtype=bool, count=rows.size)
        rows = rows[free]
    if rows.size == 0:
        return
    budget_left = (task.budget - state.pool_selected.total_cost
                   - state.admitted_cost)
    policy = resolve_selection_policy(task)
    hook = getattr(policy, "select_joiners", None)
    if hook is not None:
        picks = hook(ps.overall[rows], ps.costs[rows], budget_left,
                     state.rng)
    else:                       # legacy rule for hook-less custom policies
        picks = np.asarray(select_greedy(
            ps.overall[rows], ps.costs[rows], budget_left,
            skip_unaffordable=True).selected, dtype=np.int64)
    if picks.size == 0:
        return
    admitted = [int(c) for c in ps.client_ids[rows[picks]]]
    for c in ps.costs[rows[picks]]:
        state.admitted_cost += float(c)    # legacy fold order, bit-exact
    state.admitted.extend(admitted)
    state.pool.update(admitted)
    state.tracker.add_clients(admitted)   # one batched row append


# ---------------------------------------------------------------------------
# Multi-tenant scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RejectedTask:
    """Returned by :meth:`ServiceScheduler.submit` instead of a task id
    when the intake queue is full (``max_queue``). Nothing was enqueued,
    and the rejection carries everything needed to resubmit without any
    caller-side bookkeeping: ``task`` is the *same* :class:`TaskRequest`
    object echoed back (resubmitting it later is exactly equivalent to
    the original submit), and ``queued`` is the INTAKE backlog depth at
    rejection time — a congestion signal for sizing the retry backoff.
    The online driver (:class:`repro_torch.core.driver.OnlineDriver`)
    requeues rejected tasks from this echo alone."""

    task: TaskRequest
    reason: str
    queued: int         # INTAKE backlog size at the time of rejection


@dataclasses.dataclass
class _Tenant:
    state: TaskState
    trainer: Trainer
    availability_fn: Callable[[int, int], bool] | None = None
    stop_fn: Callable[[dict], bool] | None = None
    inflight_age: int = 0   # consecutive sweeps the pending chunk has
    # been polled not-ready (wedged-tenant eviction clock)


class ServiceScheduler:
    """N in-flight tasks against one shared client pool.

    ``submit`` queues a task in INTAKE; each ``sweep`` first serves every
    queued intake through the provider's *batched* stage 1
    (``select_pools_batch`` — one vectorized knapsack sweep for all new
    tasks), then pumps every active task one transition. Per-task
    results are identical to serial execution: each task owns its rng,
    reputation arrays and cursors, and the shared pool is only read by
    selection/scheduling.

    With ``overlap=True`` (the default) a sweep is a **two-phase pump**
    over the dispatch/collect split of the TRAINING transition: phase 1
    fills a bounded in-flight window by *enqueueing* runnable tasks'
    round chunks (:func:`dispatch` — task B's device work is in the
    queue while task A's still computes, courtesy of asynchronous
    launches); phase 2 :func:`collect` s the window in completion order
    (on a single device the FIFO execution stream makes dispatch order
    completion order), and each collected task is immediately pumped
    back into flight — its host-only transitions (POOL_SELECTED
    scheduling, PERIOD_CHECKPOINT reputation/churn sync) and its next
    enqueue run while the rest of the window is still computing, so the
    device never idles behind host bookkeeping and vice versa.
    ``max_inflight`` bounds how many un-collected chunks may be
    outstanding at once, so host/device memory for pending handles
    stays flat no matter how many tenants are served; when tenants
    outnumber the window, a FIFO ready queue rotates them through it
    (each sweep still collects at most one chunk per task, so round
    pacing across tasks stays fair). ``overlap=False`` restores the
    round-robin behaviour (one blocking :func:`step` per task
    per sweep); both modes produce bit-identical per-task results,
    overlapped is just faster (benchmarks/bench_service_multitask.py).
    The one observable difference: overlapped dispatches are issued one
    sweep early, so shared-pool churn between sweeps lands one chunk
    later than under round-robin stepping.

    **Multi-device placement** (``n_devices > 1``): tenants are spread
    over device indices ``0..n_devices-1`` by a
    :class:`~repro_torch.core.placement.PlacementPolicy` (``placement=``, by
    registry name — ``bin_pack`` packs on estimated per-round cost from
    the ``obs/latency`` telemetry window, ``round_robin`` deals
    cyclically), and the scheduler keeps one ready queue and one
    ``max_inflight``-bounded window *per device*, pumped independently
    — so a straggling chunk on one device never stalls another
    device's tenants. Trainers opt into physical placement via a
    ``place_on(device_index)`` hook (resolve ``torch.device("cuda", i)``
    there; the scheduler itself never touches torch). With
    ``rebalance_threshold`` set, a sweep whose estimated per-device
    load imbalance (max/mean) exceeds the threshold re-places tenants
    sitting at a period boundary (``POOL_SELECTED`` /
    ``PERIOD_CHECKPOINT``, nothing in flight) — migration is flush →
    re-place → resume over the ``TaskState.to_arrays`` checkpoint
    path, so per-task results are bit-identical whether or not a
    tenant ever moved. ``n_devices=1`` (the default) reduces exactly
    to the single-window pump above. See ``docs/placement.md``.

    A continuously serving provider should :meth:`retire` finished
    tasks; completed tenants are otherwise retained (with their full
    round histories) so ``results()`` stays available.
    """

    def __init__(self, provider, max_inflight: int = 8,
                 overlap: bool = True, max_queue: int | None = None,
                 inflight_deadline: int | None = None,
                 n_devices: int = 1,
                 placement: "str | placement_mod.PlacementPolicy | None"
                 = None,
                 rebalance_threshold: float | None = None):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got "
                             f"{max_inflight}")
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        if rebalance_threshold is not None and rebalance_threshold <= 1.0:
            raise ValueError(f"rebalance_threshold is a max/mean load "
                             f"ratio and must be > 1.0, got "
                             f"{rebalance_threshold}")
        self.provider = provider
        self.max_inflight = max_inflight   # per-device window bound
        self.overlap = overlap
        # backpressure: submit() returns RejectedTask once this many
        # tasks sit un-swept in INTAKE (None = unbounded)
        self.max_queue = max_queue
        # wedged-tenant guard: a pending chunk polled not-ready for this
        # many consecutive sweeps is evicted to DEGRADED, freeing its
        # window slot (None = wait forever). Only trainers
        # exposing poll(handle) participate; others collect eagerly.
        self.inflight_deadline = inflight_deadline
        self.n_devices = n_devices
        self.placement_policy = placement_mod.resolve_placement_policy(
            placement)
        self.rebalance_threshold = rebalance_threshold
        self.migrations = 0          # total tenants moved by rebalance()
        self._tenants: dict[int, _Tenant] = {}
        self._next_id = 0
        self._placement: dict[int, int] = {}   # tid -> device index
        # per-device FIFOs: [d] holds that device's tids
        self._inflight: list[list[int]] = [[] for _ in range(n_devices)]
        self._ready: list[list[int]] = [[] for _ in range(n_devices)]
        # _inflight[d]: tids with a chunk in flight on device d;
        # _ready[d]: dispatchable, waiting for a slot in d's window

    # -- intake --------------------------------------------------------------
    def submit(self, task: TaskRequest, trainer,
               availability_fn: Callable[[int, int], bool] | None = None,
               stop_fn: Callable[[dict], bool] | None = None
               ) -> int | RejectedTask:
        """Queue a task (INTAKE). Stage 1 runs batched at the next sweep.
        Returns the task id — or, when ``max_queue`` un-swept intakes are
        already waiting, a :class:`RejectedTask` (backpressure; nothing
        is enqueued)."""
        if self.max_queue is not None:
            backlog = sum(1 for t in self._tenants.values()
                          if t.state.phase == TaskPhase.INTAKE)
            if backlog >= self.max_queue:
                return RejectedTask(task=task, queued=backlog,
                                    reason=f"intake queue full "
                                           f"({backlog}/{self.max_queue}"
                                           f"); sweep() to drain")
        tid = self._next_id
        self._next_id += 1
        state = TaskState(task=task)
        state.task_id = tid
        self._tenants[tid] = _Tenant(state, resolve_trainer(trainer),
                                     availability_fn, stop_fn)
        return tid

    def adopt(self, state: TaskState, trainer,
              availability_fn: Callable[[int, int], bool] | None = None,
              stop_fn: Callable[[dict], bool] | None = None) -> int:
        """Take over an existing state (e.g. restored via
        :func:`load_state`) and drive it alongside the other tenants."""
        tid = self._next_id
        self._next_id += 1
        state.task_id = tid
        self._tenants[tid] = _Tenant(state, resolve_trainer(trainer),
                                     availability_fn, stop_fn)
        return tid

    def _intake(self) -> None:
        pending = [(tid, t) for tid, t in self._tenants.items()
                   if t.state.phase == TaskPhase.INTAKE]
        if not pending:
            return
        # the tenants' own rngs go along so stochastic selection
        # policies consume them exactly as a serial submit would
        sels = self.provider.select_pools_batch(
            [t.state.task for _, t in pending],
            rngs=[t.state.rng for _, t in pending])
        for (tid, t), sel in zip(pending, sels):
            apply_pool_selection(self.provider, t.state, sel)

    # -- stepping ------------------------------------------------------------
    @property
    def active(self) -> list[int]:
        return [tid for tid, t in self._tenants.items()
                if not t.state.phase.terminal]

    @property
    def task_ids(self) -> list[int]:
        return list(self._tenants)

    def state(self, tid: int) -> TaskState:
        return self._tenants[tid].state

    def sweep(self) -> dict[int, list[RoundEvent]]:
        """One scheduler tick: batched intake, then one transition per
        active task. Returns the events per task id, in the order the
        tasks' chunks were collected.

        Overlapped mode (see the class docstring) dispatches every
        runnable task's chunk before collecting any of them, interleaves
        host-only transitions into the gaps, and keeps at most
        ``max_inflight`` chunks outstanding. Per-task event streams are
        identical to ``overlap=False``; only wall-clock differs.
        """
        self._intake()
        self._place_new()
        if self.rebalance_threshold is not None and self.n_devices > 1:
            if placement_mod.imbalance(self._device_loads()) \
                    > self.rebalance_threshold:
                self.rebalance()
        out: dict[int, list[RoundEvent]] = {}
        if not self.overlap:                       # round-robin
            for tid, t in self._tenants.items():
                if t.state.phase.terminal:
                    continue
                t.state, ev = step(self.provider, t.state, t.trainer,
                                   availability_fn=t.availability_fn,
                                   stop_fn=t.stop_fn)
                if ev:
                    out[tid] = ev
            return out

        # refresh the ready queues with newly runnable tenants (fresh
        # intakes, adoptions, tasks bumped while the window was full);
        # each tenant joins its placed device's queue
        queued = set()
        for d in range(self.n_devices):
            queued.update(self._inflight[d], self._ready[d])
        for tid, t in self._tenants.items():
            if not t.state.phase.terminal and tid not in queued:
                self._ready[self._placement[tid]].append(tid)
        # phase 1: fill every device's in-flight window (cold start /
        # new tenants; in steady state the windows were already refilled
        # by phase 2 of the previous sweep, so every chunk computed
        # between sweeps)
        for d in range(self.n_devices):
            while (self._ready[d]
                   and len(self._inflight[d]) < self.max_inflight):
                self._pump_into_flight(self._ready[d].pop(0))
        # phase 2: collect each device's window in completion order (per
        # device the FIFO execution stream makes dispatch order
        # completion order). After each collect the task goes to the
        # back of its device's ready queue and the freed slot is
        # refilled at once — the refill runs the task's host-only
        # transitions (PERIOD_CHECKPOINT reputation/churn sync,
        # POOL_SELECTED scheduling) and enqueues its next chunk while
        # the rest of the windows are still computing, which is where
        # the overlap comes from.
        # The fixed-count loops poll each in-flight chunk at most once
        # per sweep: a not-ready (wedged) tenant is re-appended and
        # aged, never re-polled this sweep, so it cannot stall the
        # others — neither its own device's window (skipped, window
        # refilled around it) nor, since every window and queue is
        # per-device, any other device's tenants — and past
        # ``inflight_deadline`` consecutive not-ready sweeps it is
        # evicted to DEGRADED, freeing its window slot.
        for d in range(self.n_devices):
            for _ in range(len(self._inflight[d])):
                tid = self._inflight[d].pop(0)
                t = self._tenants[tid]
                if not self._handle_ready(t):
                    t.inflight_age += 1
                    if (self.inflight_deadline is not None
                            and t.inflight_age >= self.inflight_deadline):
                        self._evict(tid)
                    else:
                        self._inflight[d].append(tid)
                    continue
                t.inflight_age = 0
                t.state, ev = collect(t.state)
                if ev:
                    out.setdefault(tid, []).extend(ev)
                if not t.state.phase.terminal:
                    self._ready[d].append(tid)
                while (self._ready[d]
                       and len(self._inflight[d]) < self.max_inflight):
                    self._pump_into_flight(self._ready[d].pop(0))
        return out

    # -- placement -----------------------------------------------------------
    def device_of(self, tid: int) -> int:
        """The device index ``tid`` is placed on (0 for everything
        until the first sweep places it)."""
        return self._placement.get(tid, 0)

    def placements(self) -> dict[int, int]:
        """Snapshot of the current ``{tid: device_index}`` map."""
        return dict(self._placement)

    def _active_costs(self) -> dict[int, float]:
        return placement_mod.estimate_costs(
            {tid: t.state for tid, t in self._tenants.items()
             if not t.state.phase.terminal})

    def _device_loads(self) -> np.ndarray:
        costs = self._active_costs()
        live = {tid: d for tid, d in self._placement.items()
                if tid in costs}
        return placement_mod.device_loads(live, costs, self.n_devices)

    def _place_new(self) -> None:
        """Assign every not-yet-placed live tenant to a device and fire
        its trainer's ``place_on`` hook. Runs at the top of each sweep,
        right after intake, so placement sees post-stage-1 states."""
        fresh = [tid for tid, t in self._tenants.items()
                 if tid not in self._placement
                 and not t.state.phase.terminal]
        if not fresh:
            return
        costs = self._active_costs()
        live = {tid: d for tid, d in self._placement.items()
                if tid in costs}
        assignment = self.placement_policy.place(
            fresh, self.n_devices, costs,
            placement_mod.device_loads(live, costs, self.n_devices),
            placement_mod.device_counts(live, self.n_devices))
        for tid in fresh:
            dev = int(assignment[tid])
            if not 0 <= dev < self.n_devices:
                raise ValueError(
                    f"placement policy {self.placement_policy.name!r} "
                    f"put task {tid} on device {dev} "
                    f"(n_devices={self.n_devices})")
            self._placement[tid] = dev
            hook = getattr(self._tenants[tid].trainer, "place_on", None)
            if hook is not None:
                hook(dev)

    def rebalance(self) -> int:
        """Re-place every migratable tenant through the placement
        policy now; returns how many tenants actually moved.

        Migratable = live, nothing in flight, and sitting at a period
        boundary (``POOL_SELECTED`` / ``PERIOD_CHECKPOINT``) — a task
        mid-period keeps its device so its round stream is untouched.
        Called automatically by :meth:`sweep` when
        ``rebalance_threshold`` is set and the estimated max/mean
        device load exceeds it; safe to call manually any time.
        """
        movable = [tid for tid, t in self._tenants.items()
                   if not t.state.phase.terminal
                   and tid in self._placement
                   and t.state.pending is None
                   and t.state.phase in (TaskPhase.POOL_SELECTED,
                                         TaskPhase.PERIOD_CHECKPOINT)]
        if not movable:
            return 0
        costs = self._active_costs()
        pinned = {tid: d for tid, d in self._placement.items()
                  if tid in costs and tid not in movable}
        assignment = self.placement_policy.place(
            movable, self.n_devices, costs,
            placement_mod.device_loads(pinned, costs, self.n_devices),
            placement_mod.device_counts(pinned, self.n_devices))
        moved = 0
        for tid in movable:
            if self._migrate(tid, int(assignment[tid])):
                moved += 1
        self.migrations += moved
        return moved

    def _migrate(self, tid: int, new_dev: int) -> bool:
        """Move one boundary-parked tenant to ``new_dev`` over the
        checkpoint path: flush its control state through
        ``TaskState.to_arrays`` → ``from_arrays`` (proving the task
        would survive a cross-host move), re-home its queue entry, and
        re-place the trainer. Round/schedule histories are carried
        over — they live outside the serialized control state — so
        results are bit-identical to a never-migrated run."""
        old_dev = self._placement[tid]
        if new_dev == old_dev:
            return False
        t = self._tenants[tid]
        fresh = TaskState.from_arrays(t.state.to_arrays())
        fresh.rounds = t.state.rounds
        fresh.schedules = t.state.schedules
        t.state = fresh
        self._placement[tid] = new_dev
        if tid in self._ready[old_dev]:
            self._ready[old_dev].remove(tid)
            self._ready[new_dev].append(tid)
        hook = getattr(t.trainer, "place_on", None)
        if hook is not None:
            hook(new_dev)
        return True

    def _handle_ready(self, t: _Tenant) -> bool:
        """Whether the tenant's pending chunk can be collected without
        blocking. Trainers without a ``poll(handle) -> bool`` method (or
        sync chunks) are always treated as ready — collect() on them is
        the blocking behaviour."""
        p = t.state.pending
        if p is None or p.sync:
            return True
        poll = getattr(p.trainer, "poll", None)
        if poll is None:
            return True
        return bool(poll(p.handle))

    def _evict(self, tid: int) -> None:
        """Abandon a wedged tenant's in-flight chunk: unpin its clients,
        drop the handle, and degrade the task (terminal) so the window
        slot frees up and every other tenant keeps progressing."""
        t = self._tenants[tid]
        p = t.state.pending
        if p is not None and p.pinned is not None and p.pool is not None:
            p.pool.unpin(p.pinned)
        t.state.pending = None
        t.state.phase = TaskPhase.DEGRADED

    def _pump_into_flight(self, tid: int) -> None:
        """Advance ``tid`` until a chunk is in flight or the task is
        terminal: host-only transitions run inline (overlapping whatever
        is already enqueued), then :func:`dispatch`. A dispatch guard
        (period exhausted, ``max_rounds``/``stop`` hit) advances the
        phase host-side and the loop continues — mirroring what
        :func:`drain` does, minus the blocking collect."""
        t = self._tenants[tid]
        dev = self._placement.get(tid, 0)
        while not t.state.phase.terminal:
            if t.state.pending is not None:
                # already in flight (e.g. a state the caller dispatched
                # before adopt()): track it, don't re-dispatch
                t.inflight_age = 0
                self._inflight[dev].append(tid)
                return
            if t.state.phase in (TaskPhase.SCHEDULED, TaskPhase.TRAINING):
                # under a fault plan a dispatch may come back with
                # nothing in flight (quorum-miss retry); the loop then
                # retries inline, bounded by max_retries -> DEGRADED
                dispatch(self.provider, t.state, t.trainer,
                         stop_fn=t.stop_fn)
                if t.state.pending is not None:
                    t.inflight_age = 0
                    self._inflight[dev].append(tid)
                    return
            else:               # POOL_SELECTED / PERIOD_CHECKPOINT
                t.state, _ = step(self.provider, t.state, t.trainer,
                                  availability_fn=t.availability_fn,
                                  stop_fn=t.stop_fn)

    def run(self, max_sweeps: int = 1_000_000
            ) -> dict[int, ServiceRunResult]:
        """Drive every task to completion; returns per-task results."""
        sweeps = 0
        while self.active:
            self.sweep()
            sweeps += 1
            if sweeps >= max_sweeps:
                raise RuntimeError(f"tasks {self.active} still active "
                                   f"after {max_sweeps} sweeps")
        return self.results()

    def results(self) -> dict[int, ServiceRunResult]:
        return {tid: as_run_result(t.state)
                for tid, t in self._tenants.items()}

    def retire(self, tid: int) -> ServiceRunResult:
        """Evict a finished task and return its result. A continuously
        serving provider must retire completed tenants, or the scheduler
        retains every task's full round history forever."""
        t = self._tenants[tid]
        if not t.state.phase.terminal:
            raise ValueError(f"task {tid} still {t.state.phase.name}; "
                             f"only terminal tasks can be retired")
        del self._tenants[tid]
        self._placement.pop(tid, None)
        return as_run_result(t.state)
