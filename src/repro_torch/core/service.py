"""FL service provider orchestration (paper §III Fig. 1).

The provider owns the shared, churnable client registry
(``ClientPoolState`` struct-of-arrays; the ``ClientProfile`` dict
remains as a compatibility view) and the two-stage pipeline: stage-1
pool selection (single-task ``select_pool`` or the batched multi-tenant
``select_pools_batch``) and stage-2 per-period scheduling
(``schedule_period``). Both stages dispatch through the pluggable
policy registry (:mod:`repro_torch.core.policy`): every ``TaskRequest``
names its ``selection_policy`` / ``scheduling_policy`` pair, so tasks
running different strategies coexist on one provider.

Task orchestration itself lives in :mod:`repro_torch.core.lifecycle`: a task
is an explicit :class:`~repro_torch.core.lifecycle.TaskState` advanced by
``submit`` / ``step`` / ``drain`` (resumable, multi-tenant via
``ServiceScheduler``). The blocking :meth:`FLServiceProvider.run_task`
survives as a deprecated shim over ``submit`` + ``drain`` that
reproduces the pre-redesign results bit-for-bit;
:meth:`run_task_legacy` preserves the original loop as the equivalence
reference (tests/test_lifecycle.py), not a production path.

Model training is injected as a :class:`~repro_torch.core.lifecycle.Trainer`
(``run_rounds``) — or a legacy per-round callback, wrapped via
``single_round_adapter`` — so the same orchestration drives the paper's
CNN experiments, the LM federated runs and unit tests with stub
trainers.

Robustness (docs/robustness.md): a trainer carrying an active
:class:`~repro_torch.core.faults.FaultPlan` switches the lifecycle's
dispatch/collect split into fault mode — over-scheduled subsets,
first-k/deadline round closes, quorum retries with exponential backoff
and a terminal DEGRADED phase — while the provider's shared pool picks
up in-flight pins (deferred deregister) and per-client timing stats
that the ``straggler_aware`` selection policy consumes. With no plan
(or an inactive one) every path below is bit-identical to pre-fault
behavior; ``run_task_legacy`` remains the frozen equivalence reference.
"""
from __future__ import annotations

import warnings
from typing import Callable, Sequence

import numpy as np

from . import lifecycle
from .criteria import ClientProfile
from .lifecycle import RoundLog, ServiceRunResult, TaskRequest
from .policy import resolve_scheduling_policy, resolve_selection_policy
from .pool import ClientPoolState
from .reputation import ReputationTracker
from .scheduling import ScheduleResult
from .selection import SelectionResult

# Legacy alias: a per-round trainer callback
# (round, subset, weights) -> (returned flags, q values, metrics).
TrainerFn = Callable[[int, Sequence[int], np.ndarray], tuple]


class FLServiceProvider:
    """Client registry + the two-stage selection/scheduling pipeline."""

    def __init__(self, profiles: Sequence[ClientProfile] | ClientPoolState):
        if isinstance(profiles, ClientPoolState):
            self._pool_state = profiles
        else:
            self._pool_state = ClientPoolState.from_profiles(profiles)
        self._registry: dict[int, ClientProfile] | None = None
        self._registry_version: int | None = None

    @property
    def pool_state(self) -> ClientPoolState:
        return self._pool_state

    @pool_state.setter
    def pool_state(self, pool: ClientPoolState) -> None:
        """Replacing the pool drops every cached view derived from it."""
        self._pool_state = pool
        self._registry = None
        self._registry_version = None

    @property
    def registry(self) -> dict[int, ClientProfile]:
        """Dataclass compatibility view of the pool (built lazily so a
        100k-client ``ClientPoolState`` provider never materializes
        profiles unless asked). A read-only snapshot, rebuilt whenever
        the pool is replaced or mutated (churn — the pool's ``version``
        counter is the staleness signal): mutate ``pool_state``, not
        these profiles, to affect selection."""
        version = self._pool_state.version
        if self._registry is None or self._registry_version != version:
            self._registry = {
                p.client_id: p for p in self._pool_state.to_profiles()}
            self._registry_version = version
        return self._registry

    # -- Stage 1 -------------------------------------------------------------
    def select_pool(self, task: TaskRequest, method: str | None = None,
                    rng: np.random.Generator | None = None) -> SelectionResult:
        """Stage 1 through the task's registered selection policy
        (``task.selection_policy``, default ``paper_greedy``). An
        explicitly passed legacy ``method`` ("greedy" | "dp" |
        "random") always wins over the field."""
        policy = resolve_selection_policy(task, method)
        return policy.select(self.pool_state, task, rng)

    def select_pools_batch(self, tasks: Sequence[TaskRequest],
                           rngs: Sequence[np.random.Generator] | None = None,
                           ) -> list[SelectionResult]:
        """Stage 1 for many concurrent tasks in one batched sweep.

        Tasks are grouped by their resolved selection policy and each
        group is served by the policy's ``select_batch`` — for the
        default ``paper_greedy`` that is one vectorized threshold sweep
        plus a single batched greedy (engine.greedy_knapsack_batch)
        solving every task's knapsack at once — the multi-tenant
        serving path (``ServiceScheduler`` intake). Per-task
        feasibility (n*, Eq. 11) is applied by the policies. For
        ``paper_greedy``, selected ids come back in pool order (same
        set, totals and feasibility as per-task ``select_pool``, which
        returns greedy pick order).

        ``rngs`` supplies each task's generator (stochastic policies
        consume it exactly as a per-task ``select_pool`` would — the
        scheduler intake passes the tenants' own state rngs so batched
        and serial intake stay bit-identical); defaults to fresh
        ``default_rng(task.seed)`` per task, matching a fresh
        ``lifecycle.submit``.
        """
        if not tasks:
            return []
        if rngs is None:
            rngs = [np.random.default_rng(t.seed) for t in tasks]
        groups: dict[str, list[int]] = {}
        for i, t in enumerate(tasks):
            groups.setdefault(resolve_selection_policy(t).name, []).append(i)
        results: list[SelectionResult | None] = [None] * len(tasks)
        for name, idxs in groups.items():
            out = resolve_selection_policy(tasks[idxs[0]]).select_batch(
                self.pool_state, [tasks[i] for i in idxs],
                [rngs[i] for i in idxs])
            for i, res in zip(idxs, out):
                results[i] = res
        return results

    # -- Stage 2 (one period) --------------------------------------------------
    def schedule_period(self, pool_ids: Sequence[int], task: TaskRequest,
                        rng: np.random.Generator,
                        policy_state: dict | None = None) -> ScheduleResult:
        """One period's schedule through the task's registered
        scheduling policy (``task.scheduling_policy``; the legacy
        ``scheduler=\"random\"`` field maps to ``random_partition``).
        Raises ``KeyError`` if any id is not registered (e.g. churned
        out mid-task). ``policy_state`` is the task's policy cursor
        dict (``TaskState.policy_state``) — stateful policies read and
        mutate it; omitting it gives a stateless one-shot call."""
        rows = self.pool_state.positions(sorted(pool_ids))
        policy = resolve_scheduling_policy(task)
        return policy.schedule(
            self.pool_state.client_ids[rows], self.pool_state.histograms[rows],
            task, rng, {} if policy_state is None else policy_state)

    # -- Full service loop (deprecated shim over the lifecycle) ----------------
    def run_task(self, task: TaskRequest, trainer,
                 availability_fn: Callable[[int, int], bool] | None = None,
                 stop_fn: Callable[[dict], bool] | None = None,
                 method: str | None = None) -> ServiceRunResult:
        """Deprecated: blocking convenience wrapper over the stepped
        lifecycle (``lifecycle.submit`` + ``lifecycle.drain``).

        Produces results bit-for-bit identical to the pre-redesign
        blocking loop (kept as :meth:`run_task_legacy`; equivalence is
        tested). New code should drive the lifecycle directly — it adds
        checkpoint/resume (``TaskState.to_arrays``), multi-tenant
        serving (``ServiceScheduler``) and churn, which this blocking
        call structurally cannot express.
        """
        warnings.warn(
            "FLServiceProvider.run_task is deprecated; use "
            "repro_torch.core.lifecycle (submit/step/drain, or ServiceScheduler "
            "for multi-tenant serving) instead",
            DeprecationWarning, stacklevel=2)
        state = lifecycle.submit(self, task, method=method)
        state, _ = lifecycle.drain(self, state, trainer,
                                   availability_fn=availability_fn,
                                   stop_fn=stop_fn)
        return lifecycle.as_run_result(state)

    def run_task_legacy(self, task: TaskRequest, trainer,
                        availability_fn: Callable[[int, int], bool] | None = None,
                        stop_fn: Callable[[dict], bool] | None = None,
                        method: str | None = None) -> ServiceRunResult:
        """The pre-redesign blocking loop, verbatim — the reference the
        ``submit``/``step``/``drain`` lifecycle is equivalence-tested
        against (tests/test_lifecycle.py). Not a production path.

        availability_fn(client_id, period) -> bool models clients going
        offline (paper: conflicting schedules / battery / network).

        With ``task.round_chunk > 1`` and a chunk-capable trainer
        (``run_rounds``), consecutive rounds of a period are dispatched
        in chunks of up to ``round_chunk``; the host checkpoint between
        chunks runs stop_fn and the reputation bookkeeping. Chunks never
        straddle a period boundary (the pool update must see every round
        of the period). If stop_fn fires mid-chunk, logging stops at
        that round but the model has already advanced to the chunk end —
        known round budgets should use ``task.max_rounds``, which caps
        the chunk so the model never trains past it.
        """
        rng = np.random.default_rng(task.seed)
        pool_sel = self.select_pool(task, method=method, rng=rng)
        if not pool_sel.feasible:
            return ServiceRunResult(pool_sel, [], [], {})
        pool = set(pool_sel.selected)
        policy_state: dict = {}        # stateful scheduling-policy cursors
        tracker = ReputationTracker(pool_sel.selected,
                                    suspension_periods=task.suspension_periods,
                                    rep_threshold=task.rep_threshold)
        data_sizes = self.pool_state.data_sizes()
        chunk_size = max(1, int(task.round_chunk)) \
            if hasattr(trainer, "run_rounds") else 1
        rounds: list[RoundLog] = []
        schedules: list[ScheduleResult] = []
        global_round = 0
        for period in range(task.max_periods):
            if not pool:
                break
            if task.max_rounds is not None and global_round >= task.max_rounds:
                break
            sched = self.schedule_period(sorted(pool), task, rng,
                                         policy_state=policy_state)
            schedules.append(sched)
            stop = False
            t = 0
            while t < len(sched.subsets) and not stop:
                limit = chunk_size
                if task.max_rounds is not None:
                    remaining = task.max_rounds - global_round
                    if remaining <= 0:
                        stop = True
                        break
                    limit = min(limit, remaining)
                chunk = sched.subsets[t:t + limit]
                ws = []
                for subset in chunk:
                    sizes = data_sizes[self.pool_state.positions(subset)]
                    ws.append(sizes / np.maximum(sizes.sum(), 1e-12))
                if chunk_size > 1:
                    results = trainer.run_rounds(global_round, chunk, ws)
                else:
                    results = [trainer(global_round, chunk[0], ws[0])]
                for j, (returned, q_vals, metrics) in enumerate(results):
                    subset = chunk[j]
                    for i, cid in enumerate(subset):
                        tracker.record_round(cid, bool(returned[i]),
                                             q_value=float(q_vals[i]))
                    rounds.append(RoundLog(period, global_round, list(subset),
                                           ws[j], sched.nids[t + j], metrics))
                    global_round += 1
                    if stop_fn is not None and stop_fn(metrics):
                        stop = True
                        break
                t += len(chunk)
            avail = {cid: (availability_fn(cid, period + 1)
                           if availability_fn else True)
                     for cid in tracker.records}
            pool = tracker.update_pool(pool, avail) & set(pool_sel.selected)
            if stop:
                break
        return ServiceRunResult(pool_sel, rounds, schedules, tracker.scores())
