"""Pluggable selection & scheduling policies (the control-plane seam).

Without this seam the paper's two stages — budget-greedy pool selection
(§V) and iid-subset per-round scheduling (§VI, Algorithm 1) — were the
*only* strategies the service could run, hard-wired through
``core.selection`` / ``core.scheduling`` imports inside
``FLServiceProvider`` and the lifecycle transitions. This module
inverts that dependency: the provider and lifecycle talk to two small
protocols, and concrete strategies register themselves by name so a
:class:`~repro_torch.core.lifecycle.TaskRequest` can pick its pair
(``selection_policy=\"paper_greedy\"``,
``scheduling_policy=\"iid_subsets\"``) — per task, on one shared pool,
A/B-able inside a single ``ServiceScheduler``.

Protocols
---------

- :class:`SelectionPolicy` — stage 1: ``select(pool, task, rng)`` maps
  the shared ``ClientPoolState`` + a ``TaskRequest`` to a
  ``SelectionResult`` (the task's client pool under its budget /
  ``n_star`` / thresholds). ``select_batch`` serves many concurrent
  tasks in one call — the multi-tenant intake path; the default simply
  loops, the paper policy overrides it with the batched knapsack
  sweep (``engine.greedy_knapsack_batch``, not ported yet: it raises).
- :class:`SchedulingPolicy` — stage 2: ``schedule(ids, histograms,
  task, rng, policy_state)`` maps the task's current pool (ascending-id
  ``(P,)`` ids + ``(P, c)`` label histograms) to a ``ScheduleResult``
  (the period's padded subset schedule the lifecycle consumes).
  ``policy_state`` is a mutable ``{key: numpy array}`` dict owned by
  the ``TaskState`` and checkpointed with it
  (``TaskState.to_arrays``), so stateful policies (participation
  EMAs, round-robin cursors) survive save → kill → restore.

Every registered scheduling policy must uphold the paper's §VII
fairness guarantee — every pooled client scheduled >= once per period,
nobody more than ``x_star`` times, subset sizes in ``[n-δ, n+δ]`` —
property-checked for all registered policies in
``tests/test_fairness.py``.

Shipped policies
----------------

Selection: ``paper_greedy`` (default; §VI-A score/cost-ratio greedy,
bit-identical to the pre-registry ``select_pool`` /
``select_pools_batch``), ``dp`` (exact knapsack), ``random`` (the
paper's uniform baseline), ``score_prop`` (score-proportional sampling
under the same budget — the softened baseline used by fairness-aware
selection papers).

Scheduling: ``iid_subsets`` (default; Algorithm 1, bit-identical to
the pre-registry ``generate_subsets`` path), ``random_partition``
(the paper's random baseline; also what the legacy
``TaskRequest.scheduler=\"random\"`` maps to), ``fair_ema``
(participation-EMA-penalized scheduling in the spirit of Shi et al.,
*Fairness-Aware Client Selection for Federated Learning*, 2023 — see
:class:`FairEMAScheduling`).

Adding a policy
---------------

::

    from repro_torch.core import policy

    @policy.register_selection_policy
    class CheapestFirst:
        name = "cheapest_first"
        def select(self, pool, task, rng):
            ...
        def select_batch(self, pool, tasks, rngs):
            return [self.select(pool, t, r) for t, r in zip(tasks, rngs)]

    TaskRequest(budget=100.0, selection_policy="cheapest_first")

See ``docs/policies.md`` for the full contracts.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Protocol, Sequence, runtime_checkable

import numpy as np

from . import engine
from .criteria import nid
from .pool import ClientPoolState
from .scheduling import ScheduleResult, generate_subsets, random_subsets
from .selection import (SelectionResult, select_dp, select_greedy,
                        select_initial_pool, select_random,
                        select_score_prop, select_score_prop_batch)

if TYPE_CHECKING:                     # import cycle: lifecycle imports
    from .lifecycle import TaskRequest  # selection/scheduling like we do


# ---------------------------------------------------------------------------
# Protocols
# ---------------------------------------------------------------------------

@runtime_checkable
class SelectionPolicy(Protocol):
    """Stage 1 strategy: pool-state arrays + TaskRequest -> selected pool.

    Implementations must be stateless (one shared instance serves every
    task); anything that must persist belongs in the task's rng or its
    ``policy_state``. ``select`` consumes ``rng`` deterministically (or
    not at all), so a task restored from a checkpoint re-selects
    identically.

    Policies may additionally implement the *optional* hook
    ``select_joiners(scores, costs, budget_left, rng) -> positions``:
    the admission rule for threshold-eligible clients that join
    mid-period (``PERIOD_CHECKPOINT`` churn, see ``core.lifecycle``).
    It is looked up with ``getattr`` — deliberately NOT part of this
    protocol, so pre-existing custom policies keep registering; tasks
    running a policy without the hook fall back to the legacy greedy
    admission rule.
    """

    name: str

    def select(self, pool: ClientPoolState, task: "TaskRequest",
               rng: np.random.Generator | None) -> SelectionResult: ...

    def select_batch(self, pool: ClientPoolState,
                     tasks: Sequence["TaskRequest"],
                     rngs: Sequence[np.random.Generator | None],
                     ) -> list[SelectionResult]: ...


@runtime_checkable
class SchedulingPolicy(Protocol):
    """Stage 2 strategy: pool arrays + per-task history -> period schedule.

    ``ids``/``histograms`` are the task's *current* pool in ascending-id
    order (``(P,)`` int64, ``(P, c)`` float64). ``policy_state`` is the
    task-owned ``{key: numpy array}`` cursor dict — read what you wrote
    last period, write what the next period needs; it round-trips
    through ``TaskState.to_arrays`` so keys must be strings and values
    numpy arrays. Stateless policies simply ignore it.

    Every implementation must uphold the §VII guarantee: coverage
    (every pooled client in >= 1 subset), bounded participation
    (<= ``task.x_star``), and subset sizes in
    ``[task.subset_size - task.subset_delta, task.subset_size +
    task.subset_delta]`` (the final subset may be the smaller tail).
    ``tests/test_fairness.py`` property-checks all registered policies.
    """

    name: str

    def schedule(self, ids: np.ndarray, histograms: np.ndarray,
                 task: "TaskRequest", rng: np.random.Generator,
                 policy_state: dict[str, np.ndarray]) -> ScheduleResult: ...


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_SELECTION: dict[str, SelectionPolicy] = {}
_SCHEDULING: dict[str, SchedulingPolicy] = {}

DEFAULT_SELECTION_POLICY = "paper_greedy"
DEFAULT_SCHEDULING_POLICY = "iid_subsets"

# Legacy spellings kept alive by the registry: the stage-1 ``method=``
# argument (submit/run_task) and TaskRequest.scheduler="random".
_LEGACY_METHOD_TO_POLICY = {"greedy": "paper_greedy", "dp": "dp",
                            "random": "random"}
_LEGACY_SCHEDULER_TO_POLICY = {"mkp": "iid_subsets",
                               "random": "random_partition"}


def register_selection_policy(policy):
    """Register a :class:`SelectionPolicy` class or instance under its
    ``name``. Usable as a class decorator; duplicate names raise."""
    inst = policy() if isinstance(policy, type) else policy
    if not isinstance(inst, SelectionPolicy):
        raise TypeError(f"{policy!r} does not implement SelectionPolicy "
                        f"(name, select, select_batch)")
    if inst.name in _SELECTION:
        raise ValueError(f"selection policy {inst.name!r} already registered")
    _SELECTION[inst.name] = inst
    return policy


def register_scheduling_policy(policy):
    """Register a :class:`SchedulingPolicy` class or instance under its
    ``name``. Usable as a class decorator; duplicate names raise."""
    inst = policy() if isinstance(policy, type) else policy
    if not isinstance(inst, SchedulingPolicy):
        raise TypeError(f"{policy!r} does not implement SchedulingPolicy "
                        f"(name, schedule)")
    if inst.name in _SCHEDULING:
        raise ValueError(f"scheduling policy {inst.name!r} already registered")
    _SCHEDULING[inst.name] = inst
    return policy


def selection_policy(name: str) -> SelectionPolicy:
    try:
        return _SELECTION[name]
    except KeyError:
        raise KeyError(f"unknown selection policy {name!r}; registered: "
                       f"{available_selection_policies()}") from None


def scheduling_policy(name: str) -> SchedulingPolicy:
    try:
        return _SCHEDULING[name]
    except KeyError:
        raise KeyError(f"unknown scheduling policy {name!r}; registered: "
                       f"{available_scheduling_policies()}") from None


def available_selection_policies() -> list[str]:
    return sorted(_SELECTION)


def available_scheduling_policies() -> list[str]:
    return sorted(_SCHEDULING)


def resolve_selection_policy(task, method: str | None = None
                             ) -> SelectionPolicy:
    """The task's stage-1 policy. An explicitly passed legacy
    ``method=`` argument (``submit`` / ``run_task`` /
    ``select_pool``) always wins — including ``method=\"greedy\"``;
    otherwise ``task.selection_policy`` decides, falling back to the
    default (``paper_greedy``) when the field is unset (``None``)."""
    if method is not None:
        return selection_policy(_LEGACY_METHOD_TO_POLICY.get(method, method))
    name = getattr(task, "selection_policy", None)
    return selection_policy(name or DEFAULT_SELECTION_POLICY)


def resolve_scheduling_policy(task) -> SchedulingPolicy:
    """The task's stage-2 policy. An explicitly set
    ``task.scheduling_policy`` always wins; when unset (``None``) the
    legacy ``TaskRequest.scheduler`` alias decides (``\"mkp\"`` ->
    ``iid_subsets``, ``\"random\"`` -> ``random_partition``)."""
    name = getattr(task, "scheduling_policy", None)
    if name is None:
        legacy = getattr(task, "scheduler", "mkp")
        name = _LEGACY_SCHEDULER_TO_POLICY.get(legacy, legacy)
    return scheduling_policy(name)


# ---------------------------------------------------------------------------
# Selection policies
# ---------------------------------------------------------------------------

class _BudgetedSelection:
    """Shared stage-1 shape: threshold filter -> feasibility -> a
    knapsack-style solver, via :func:`selection.select_initial_pool`
    (so every budgeted policy shares the Eq. 8d / Eq. 11 handling and
    the infeasibility notes)."""

    name: str
    method: str                       # select_initial_pool solver key

    def select(self, pool, task, rng):
        return select_initial_pool(
            pool, budget=task.budget, n_star=task.n_star,
            thresholds=task.thresholds, method=self.method, rng=rng)

    def select_batch(self, pool, tasks, rngs):
        return [self.select(pool, t, r) for t, r in zip(tasks, rngs)]

    def select_joiners(self, scores, costs, budget_left, rng):
        """Admit mid-period joiners with this policy's own solver
        (thresholds were already applied by the lifecycle; the knapsack
        here is over the leftover budget). Returns candidate positions
        in pick order. The greedy solver runs in skip-unaffordable mode
        — bit-identical to the legacy hard-coded admission loop."""
        rng = rng or np.random.default_rng(0)
        if self.method == "dp":
            res = select_dp(scores, costs, budget_left)
        elif self.method == "random":
            res = select_random(scores, costs, budget_left, rng)
        elif self.method == "score_prop":
            res = select_score_prop(scores, costs, budget_left, rng)
        else:
            res = select_greedy(scores, costs, budget_left,
                                skip_unaffordable=True)
        return np.asarray(res.selected, dtype=np.int64)


@register_selection_policy
class PaperGreedySelection(_BudgetedSelection):
    """The paper's §VI-A score/cost-ratio greedy (the default).

    ``select`` is bit-identical to the pre-registry
    ``FLServiceProvider.select_pool``; ``select_batch`` is the
    pre-registry ``select_pools_batch`` — one vectorized threshold
    sweep + one batched greedy knapsack for every task at once
    (selected ids come back in pool order; same set/totals/feasibility
    as ``select``, which returns greedy pick order). The batched greedy
    is not ported yet: ``engine.greedy_knapsack_batch`` raises."""

    name = "paper_greedy"
    method = "greedy"

    def select_batch(self, pool, tasks, rngs):
        budgets = np.array([t.budget for t in tasks], dtype=np.float64)
        valid = np.stack([pool.threshold_mask(t.thresholds) for t in tasks])
        masks, _, _ = engine.greedy_knapsack_batch(
            pool.overall, pool.costs, budgets, valid)
        results: list[SelectionResult] = []
        for t, task in enumerate(tasks):
            n_kept = int(valid[t].sum())
            if n_kept < task.n_star:
                results.append(SelectionResult(
                    [], 0.0, 0.0, feasible=False,
                    note=f"only {n_kept} clients pass thresholds, "
                         f"need {task.n_star}"))
                continue
            sel = masks[t]
            res = SelectionResult(
                pool.client_ids[sel].tolist(),
                float(pool.overall[sel].sum()),
                float(pool.costs[sel].sum()))
            if len(res.selected) < task.n_star:
                res.feasible = False
                floor = pool.budget_floor(task.n_star, valid[t])
                res.note = (f"budget {task.budget} selects only "
                            f"{len(res.selected)} < n*={task.n_star} "
                            f"clients; Eq.(11) floor is {floor:.1f}")
            results.append(res)
        return results


@register_selection_policy
class DPSelection(_BudgetedSelection):
    """Exact 0-1 knapsack (O(n·B) DP) — the paper's optimal reference."""

    name = "dp"
    method = "dp"


@register_selection_policy
class RandomSelection(_BudgetedSelection):
    """The paper's uniform baseline: random clients until the budget is
    short."""

    name = "random"
    method = "random"


@register_selection_policy
class ScoreProportionalSelection(_BudgetedSelection):
    """Score-proportional sampling under the same budget: clients are
    drawn without replacement with probability proportional to their
    overall score (Efraimidis–Spirakis weighted order), with the same
    stop-at-first-unaffordable budget scan as ``random``. The softened
    baseline fairness-aware selection papers compare against — higher
    expected pool quality than uniform, a selection *chance* for every
    thresholded client unlike the deterministic greedy."""

    name = "score_prop"
    method = "score_prop"

    def select_batch(self, pool, tasks, rngs):
        """Batched weighted sampling: per-task Gumbel/Efraimidis–
        Spirakis keys drawn serially (identical rng consumption to
        ``select`` — infeasible tasks draw nothing), then ONE stacked
        ``(T, n)`` argsort + left-fold budget sweep
        (``selection.select_score_prop_batch``). Bit-identical to the
        serial loop per task (asserted in tests/test_scale_plane.py)."""
        if not isinstance(pool, ClientPoolState):
            return super().select_batch(pool, tasks, rngs)
        valid = np.stack([pool.threshold_mask(t.thresholds) for t in tasks])
        n_keeps = valid.sum(axis=1)
        run = [t for t in range(len(tasks)) if n_keeps[t] >= tasks[t].n_star]
        batch = select_score_prop_batch(
            pool.overall, pool.costs,
            np.array([tasks[t].budget for t in run], dtype=np.float64),
            [rngs[t] or np.random.default_rng(0) for t in run],
            valid[run]) if run else []
        results: list[SelectionResult | None] = [None] * len(tasks)
        for t, task in enumerate(tasks):
            if n_keeps[t] < task.n_star:
                results[t] = SelectionResult(
                    [], 0.0, 0.0, feasible=False,
                    note=f"only {int(n_keeps[t])} clients pass thresholds, "
                         f"need {task.n_star}")
        for j, t in enumerate(run):
            picks, ts, tc = batch[j]
            task = tasks[t]
            res = SelectionResult(pool.client_ids[picks].tolist(), ts, tc)
            if len(res.selected) < task.n_star:
                res.feasible = False
                floor = pool.budget_floor(task.n_star, valid[t])
                res.note = (f"budget {task.budget} selects only "
                            f"{len(res.selected)} < n*={task.n_star} "
                            f"clients; Eq.(11) floor is {floor:.1f}")
            results[t] = res
        return results


@register_selection_policy
class StragglerAwareSelection(_BudgetedSelection):
    """Score/cost greedy over *timeout-discounted* scores: each client's
    overall score is scaled by ``1 - penalty * timeout_rate`` before the
    budget greedy, where ``timeout_rate`` is the shared pool's observed
    fraction of dispatches that missed their round's collect close
    (``ClientPoolState.timeout_rate()``, fed by the lifecycle's
    fault-mode bookkeeping — see docs/robustness.md). Chronic stragglers
    price themselves out of stage 1; clients with no dispatch history
    are undiscounted. On pools without timing stats (plain profile
    tuples) this degrades to exactly ``paper_greedy``. Reported
    ``total_score``/``total_cost`` use the *undiscounted* values, so
    results stay comparable across policies."""

    name = "straggler_aware"
    method = "greedy"
    penalty = 1.0       # full discount: a 100%-timeout client scores 0

    def select(self, pool, task, rng):
        if not isinstance(pool, ClientPoolState):
            return super().select(pool, task, rng)
        valid = pool.threshold_mask(task.thresholds)
        n_kept = int(valid.sum())
        if n_kept < task.n_star:
            return SelectionResult(
                [], 0.0, 0.0, feasible=False,
                note=f"only {n_kept} clients pass thresholds, "
                     f"need {task.n_star}")
        rows = np.flatnonzero(valid)
        rate = pool.timeout_rate()[rows]
        eff = pool.overall[rows] * np.maximum(
            1.0 - self.penalty * rate, 0.0)
        picks = np.asarray(select_greedy(
            eff, pool.costs[rows], task.budget,
            skip_unaffordable=True).selected, dtype=np.int64)
        sel = rows[picks]
        res = SelectionResult(
            pool.client_ids[sel].tolist(),
            float(pool.overall[sel].sum()),
            float(pool.costs[sel].sum()))
        if len(res.selected) < task.n_star:
            res.feasible = False
            floor = pool.budget_floor(task.n_star, valid)
            res.note = (f"budget {task.budget} selects only "
                        f"{len(res.selected)} < n*={task.n_star} "
                        f"clients; Eq.(11) floor is {floor:.1f}")
        return res


# ---------------------------------------------------------------------------
# Scheduling policies
# ---------------------------------------------------------------------------

@register_scheduling_policy
class PaperIIDSubsetScheduling:
    """Algorithm 1 *Generate Subsets* (the default): per-class MKPs with
    Nid-improvement and complementary knapsacks — bit-identical to the
    pre-registry ``generate_subsets`` path."""

    name = "iid_subsets"

    def schedule(self, ids, histograms, task, rng, policy_state):
        return generate_subsets(
            (ids, histograms), n=task.subset_size, delta=task.subset_delta,
            x_star=task.x_star, nid_threshold=task.nid_threshold)


@register_scheduling_policy
class RandomPartitionScheduling:
    """The paper's random baseline: shuffle the pool, slice into subsets
    of size n — bit-identical to the legacy ``scheduler=\"random\"``
    path (which it now backs)."""

    name = "random_partition"

    def schedule(self, ids, histograms, task, rng, policy_state):
        hists = {int(c): histograms[i] for i, c in enumerate(ids)}
        return random_subsets(hists, task.subset_size, rng)


@register_scheduling_policy
class FairEMAScheduling:
    """Participation-EMA-penalized scheduling (in the spirit of Shi et
    al., *Fairness-Aware Client Selection for Federated Learning*, 2023,
    and *Emulating Full Participation*, 2024).

    Across periods the policy keeps an exponential moving average of
    each client's per-period participation count in ``policy_state``
    (``fair_ema/ids`` + ``fair_ema/ema`` — checkpointed with the task).
    Each period:

    1. every pooled client gets exactly one *base* slot — subsets are
       consecutive size-``n`` slices of the pool ordered by ascending
       EMA, so chronically under-served clients train in the period's
       *earliest* rounds (they still train even when ``max_rounds`` or a
       ``stop_fn`` truncates the period);
    2. the ``delta`` headroom of every subset is filled with
       *compensation* slots handed to the least-served eligible clients
       (lowest ``EMA + extras-granted-this-period``, capped at
       ``x_star`` total appearances) — over-served clients participate
       exactly once, under-served up to ``x_star`` times, which is what
       drags the long-run participation counts together;
    3. the EMA is updated from the drawn schedule's counts, so the
       compensation pressure decays once counts equalize (and rotates:
       this period's compensated clients are next period's back of the
       queue).

    §VII guarantees hold by construction: step 1 is a partition
    (coverage), step 2 respects ``x_star`` and the ``n + delta`` size
    cap. Deterministic — the penalty order, not the rng, breaks ties —
    so checkpoint/resume reproduces schedules exactly.
    """

    name = "fair_ema"
    alpha = 0.5                       # EMA weight of the newest period

    def schedule(self, ids, histograms, task, rng, policy_state):
        ids = np.asarray(ids, dtype=np.int64)
        H = np.asarray(histograms, dtype=np.float64)
        order0 = np.argsort(ids, kind="stable")   # canonical ascending ids
        ids, H = ids[order0], H[order0]
        P = ids.size
        if P == 0:
            return ScheduleResult([], [], {}, np.zeros(0))
        n = max(1, int(task.subset_size))
        delta = max(0, int(task.subset_delta))
        x_star = max(1, int(task.x_star))
        ema = self._lookup_ema(policy_state, ids)

        order = np.argsort(ema, kind="stable")    # least-served first
        subsets_rows = [order[i: i + n] for i in range(0, P, n)]
        counts = np.ones(P, dtype=np.int64)
        if delta > 0 and x_star > 1 and len(subsets_rows) > 1:
            in_s = np.zeros(P, dtype=bool)
            for j, s in enumerate(subsets_rows):
                room = n + delta - s.size
                if room <= 0:
                    continue
                in_s[:] = False
                in_s[s] = True
                cand = np.flatnonzero(~in_s & (counts < x_star))
                if cand.size == 0:
                    continue
                # least-served first: historical EMA + compensation
                # already granted this period (counts - 1)
                penalty = ema[cand] + (counts[cand] - 1)
                take = cand[np.argsort(penalty, kind="stable")][:room]
                subsets_rows[j] = np.concatenate([s, take])
                counts[take] += 1

        policy_state["fair_ema/ids"] = ids.copy()
        policy_state["fair_ema/ema"] = \
            (1.0 - self.alpha) * ema + self.alpha * counts.astype(np.float64)
        subsets = [np.sort(ids[s]).tolist() for s in subsets_rows]
        nids = [float(nid(H[s].sum(axis=0))) for s in subsets_rows]
        count_map = {int(ids[i]): int(counts[i]) for i in range(P)}
        return ScheduleResult(subsets, nids, count_map, np.zeros(0))

    def _lookup_ema(self, policy_state, ids: np.ndarray) -> np.ndarray:
        """Previous-period EMAs for ``ids`` (0 for clients never seen —
        joiners start with maximal compensation priority). Stored ids
        are ascending (we write them that way), so a searchsorted join
        survives churn in either direction."""
        ema = np.zeros(ids.size, dtype=np.float64)
        prev_ids = policy_state.get("fair_ema/ids")
        if prev_ids is None or np.asarray(prev_ids).size == 0:
            return ema
        prev_ids = np.asarray(prev_ids, dtype=np.int64)
        prev_ema = np.asarray(policy_state["fair_ema/ema"], dtype=np.float64)
        pos = np.searchsorted(prev_ids, ids)
        pos_c = np.minimum(pos, prev_ids.size - 1)
        hit = prev_ids[pos_c] == ids
        ema[hit] = prev_ema[pos_c[hit]]
        return ema


@register_scheduling_policy
class DeadlineAwareScheduling:
    """Timing-reactive scheduling: demote chronic stragglers, tighten
    over-scheduling as observed latency approaches the collect deadline.

    The lifecycle publishes per-task timing observability columns into
    ``policy_state`` every period (docs/workloads.md): ``obs/ids`` /
    ``obs/timeouts`` / ``obs/rounds`` — the reputation tracker's timing
    arrays — plus a rolling ``obs/latency`` window of fault-mode
    simulated round latencies. This policy is the first consumer,
    reacting *mid-task* where ``straggler_aware`` only filters at
    stage 1:

    1. **Demotion.** Pooled clients are ordered by ascending observed
       timeout rate (``timeouts / (rounds + timeouts)``, 0 for clients
       with no history; ties by ascending id) and partitioned into
       consecutive size-``n`` subsets. Chronic-slow members land in the
       period's *last* subsets: under first-k/deadline collect the
       healthy-only subsets close fast, and when ``max_rounds`` or a
       ``stop_fn`` truncates the period it is the straggler subsets
       that go untrained. Every client appears exactly once, so each
       period is a partition — coverage and the ``x_star`` bound hold
       trivially and per-period participation is maximally fair
       (Jain = 1 over scheduled slots).
    2. **Deadline control.** With a ``collect_deadline`` set and
       latency observations present, the policy compares the window's
       p99 against the deadline: at >= ``pressure`` x deadline it
       multiplicatively raises ``task.overschedule_factor`` (capped at
       ``os_cap``) so rounds close at first-k before the deadline
       forces a short count; at < ``relax`` x deadline it decays the
       factor back toward the submitted value (stored in
       ``deadline_aware/base_os`` on first sight). The mutation lives
       on the task's own ``TaskRequest`` — serialized with the task, so
       checkpoint/resume keeps the adapted factor.

    Deterministic given (pool, observability columns) — the rng is
    never drawn — so checkpoint/resume replays schedules exactly.
    """

    name = "deadline_aware"
    pressure = 0.8      # p99 >= pressure * deadline -> tighten
    relax = 0.5         # p99 <  relax * deadline    -> decay toward base
    os_step = 1.25      # multiplicative tighten step
    os_cap = 3.0        # overschedule_factor ceiling

    def schedule(self, ids, histograms, task, rng, policy_state):
        ids = np.asarray(ids, dtype=np.int64)
        H = np.asarray(histograms, dtype=np.float64)
        order0 = np.argsort(ids, kind="stable")   # canonical ascending ids
        ids, H = ids[order0], H[order0]
        P = ids.size
        if P == 0:
            return ScheduleResult([], [], {}, np.zeros(0))
        n = max(1, int(task.subset_size))

        self._adapt_overschedule(task, policy_state)

        rate = self._timeout_rate(policy_state, ids)
        order = np.argsort(rate, kind="stable")   # healthy first; rate
        # ties (incl. the no-history cold start) fall back to ascending
        # id via the stable sort over already-sorted ids
        subsets_rows = [order[i: i + n] for i in range(0, P, n)]
        subsets = [np.sort(ids[s]).tolist() for s in subsets_rows]
        nids = [float(nid(H[s].sum(axis=0))) for s in subsets_rows]
        count_map = {int(c): 1 for c in ids}
        return ScheduleResult(subsets, nids, count_map, np.zeros(0))

    def _timeout_rate(self, policy_state, ids: np.ndarray) -> np.ndarray:
        """Observed timeout rate per pooled client (0 = no history)."""
        obs_ids = policy_state.get("obs/ids")
        if obs_ids is None or np.asarray(obs_ids).size == 0:
            return np.zeros(ids.size, dtype=np.float64)
        obs_ids = np.asarray(obs_ids, dtype=np.int64)
        tf = np.asarray(policy_state.get("obs/timeouts",
                                         np.zeros(obs_ids.size)),
                        dtype=np.float64)
        nr = np.asarray(policy_state.get("obs/rounds",
                                         np.zeros(obs_ids.size)),
                        dtype=np.float64)
        obs_rate = tf / np.maximum(tf + nr, 1.0)
        # tracker ids are insertion-ordered, not sorted: sort for the join
        o = np.argsort(obs_ids, kind="stable")
        obs_ids, obs_rate = obs_ids[o], obs_rate[o]
        rate = np.zeros(ids.size, dtype=np.float64)
        pos = np.searchsorted(obs_ids, ids)
        pos_c = np.minimum(pos, obs_ids.size - 1)
        hit = obs_ids[pos_c] == ids
        rate[hit] = obs_rate[pos_c[hit]]
        return rate

    def _adapt_overschedule(self, task, policy_state) -> None:
        if task.collect_deadline <= 0.0:
            return
        base = policy_state.get("deadline_aware/base_os")
        if base is None:
            base = np.array([max(1.0, float(task.overschedule_factor))])
            policy_state["deadline_aware/base_os"] = base
        lat = policy_state.get("obs/latency")
        if lat is None or np.asarray(lat).size == 0:
            return
        p99 = float(np.percentile(np.asarray(lat, dtype=np.float64), 99))
        factor = max(1.0, float(task.overschedule_factor))
        if p99 >= self.pressure * task.collect_deadline:
            task.overschedule_factor = min(self.os_cap,
                                           factor * self.os_step)
        elif p99 < self.relax * task.collect_deadline:
            task.overschedule_factor = max(float(base[0]),
                                           factor / self.os_step)
