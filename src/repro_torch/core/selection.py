"""Stage 1: initial client pool selection (paper §V-A, §VI-A).

After threshold filtering (Eq. 8d) and the budget-floor check (Eq. 11),
the problem is a 0-1 knapsack (Eq. 12): maximize total Score subject to
total Cost <= B. We provide:

- ``select_greedy``  — the paper's O(n log n) score/cost-ratio greedy,
  vectorized (argsort + cumulative-sum prefix via ``core.engine``);
- ``select_greedy_legacy`` — the original per-client Python loop, kept
  as the bit-exact reference for equivalence tests and benchmarks;
- ``select_dp``      — exact dynamic programming, O(n·B) (integer costs);
- ``select_random``  — the paper's random baseline;
- ``select_score_prop`` — score-proportional sampling under the same
  budget (beyond-paper baseline, see ``core.policy``);

plus the full Stage-1 wrapper ``select_initial_pool`` implementing the
threshold filter and minimum-pool-size feasibility check. The wrapper
accepts either the legacy ``list[ClientProfile]`` or an array-native
``ClientPoolState`` (the internal representation; profile lists are
converted once and processed with masked array ops).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from . import engine
from .criteria import THRESHOLDED, ClientProfile
from .pool import ClientPoolState


@dataclasses.dataclass
class SelectionResult:
    selected: list[int]          # client ids, in selection order
    total_score: float
    total_cost: float
    feasible: bool = True
    note: str = ""

    def approx_ratio(self, optimal_score: float) -> float:
        """Paper's 'approximation ratio': relative gap to the optimum."""
        if optimal_score <= 0:
            return 0.0
        return (optimal_score - self.total_score) / optimal_score


def _totals(ids: Sequence[int], scores, costs) -> tuple[float, float]:
    idx = list(ids)
    return float(np.sum(scores[idx])) if idx else 0.0, \
        float(np.sum(costs[idx])) if idx else 0.0


# ---------------------------------------------------------------------------
# Knapsack solvers
# ---------------------------------------------------------------------------

def select_greedy(scores: np.ndarray, costs: np.ndarray, budget: float,
                  ids: Sequence[int] | None = None,
                  skip_unaffordable: bool = False) -> SelectionResult:
    """Greedy by non-increasing score/cost ratio (§VI-A), vectorized.

    With ``skip_unaffordable=False`` (paper-faithful, reproduces Table III:
    5 clients / 32.78) the scan stops at the first client whose cost
    exceeds the remaining budget. ``skip_unaffordable=True`` is the
    beyond-paper variant that keeps scanning for cheaper clients further
    down the ratio order — it dominates the paper's variant pointwise
    (recorded in EXPERIMENTS.md §Perf/control-plane).

    Selections are identical to :func:`select_greedy_legacy` (tested in
    tests/test_engine.py); the hot path is ``engine.greedy_knapsack``.
    """
    scores = np.asarray(scores, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    chosen, ts, tc = engine.greedy_knapsack(
        scores, costs, budget, skip_unaffordable=skip_unaffordable)
    if ids is None:
        sel = [int(j) for j in chosen]
    else:
        ids = list(ids)
        sel = [ids[j] for j in chosen]
    return SelectionResult(sel, ts, tc)


def select_greedy_legacy(scores: np.ndarray, costs: np.ndarray, budget: float,
                         ids: Sequence[int] | None = None,
                         skip_unaffordable: bool = False) -> SelectionResult:
    """The original per-client Python-loop greedy, kept as the reference
    implementation the vectorized path is tested against (and as the
    baseline for benchmarks/bench_selection_time.py)."""
    scores = np.asarray(scores, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    ids = list(range(len(scores))) if ids is None else list(ids)
    ratio = scores / np.maximum(costs, 1e-12)
    order = np.argsort(-ratio, kind="stable")
    chosen: list[int] = []
    remaining = float(budget)
    for j in order:
        c = float(costs[j])
        if c <= remaining:
            chosen.append(j)
            remaining -= c
        elif not skip_unaffordable:
            break
    ts, tc = _totals(chosen, scores, costs)
    return SelectionResult([ids[j] for j in chosen], ts, tc)


def select_dp(scores: np.ndarray, costs: np.ndarray, budget: float,
              ids: Sequence[int] | None = None) -> SelectionResult:
    """Exact 0-1 knapsack DP, O(n·B). Costs are rounded to integers
    (the paper rounds costs to the nearest integer for convenience)."""
    scores = np.asarray(scores, dtype=np.float64)
    icosts = np.rint(np.asarray(costs, dtype=np.float64)).astype(np.int64)
    if np.any(icosts < 0):
        raise ValueError("negative costs")
    ids = list(range(len(scores))) if ids is None else list(ids)
    B = int(np.floor(budget))
    n = len(scores)
    # dp[b] = best score with capacity b; keep[i] = bitset over capacities
    dp = np.zeros(B + 1, dtype=np.float64)
    keep = np.zeros((n, B + 1), dtype=bool)
    for i in range(n):
        c, s = int(icosts[i]), float(scores[i])
        if c > B:
            continue
        cand = dp[: B - c + 1] + s
        upd = cand > dp[c:]
        keep[i, c:][upd] = True
        dp[c:][upd] = cand[upd]
    # backtrack
    b = int(np.argmax(dp))
    chosen: list[int] = []
    for i in range(n - 1, -1, -1):
        if keep[i, b]:
            chosen.append(i)
            b -= int(icosts[i])
    chosen.reverse()
    ts, tc = _totals(chosen, scores, np.asarray(costs, dtype=np.float64))
    return SelectionResult([ids[j] for j in chosen], ts, tc)


def select_random(scores: np.ndarray, costs: np.ndarray, budget: float,
                  rng: np.random.Generator,
                  ids: Sequence[int] | None = None) -> SelectionResult:
    """Random baseline: add random clients until the budget is short.

    Matches the paper: "randomly selects clients until the budget is
    short" — i.e. stops at the first client that does not fit.
    """
    scores = np.asarray(scores, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    ids = list(range(len(scores))) if ids is None else list(ids)
    order = rng.permutation(len(scores))
    chosen: list[int] = []
    remaining = float(budget)
    for j in order:
        if costs[j] > remaining:
            break
        chosen.append(int(j))
        remaining -= float(costs[j])
    ts, tc = _totals(chosen, scores, costs)
    return SelectionResult([ids[j] for j in chosen], ts, tc)


def select_score_prop(scores: np.ndarray, costs: np.ndarray, budget: float,
                      rng: np.random.Generator,
                      ids: Sequence[int] | None = None) -> SelectionResult:
    """Score-proportional sampling under the budget (beyond-paper
    baseline; backs the ``score_prop`` policy in ``core.policy``).

    Clients are ordered by a weighted random draw without replacement
    — Efraimidis–Spirakis keys, computed in log space
    (``log(u)/score``, the same ordering as ``u^(1/score)`` but immune
    to the underflow that collapses ``u^(1/w)`` to 0.0 for small
    scores and silently degenerates the draw into index order) — so
    the probability of being drawn early is proportional to the
    overall score; then the same stop-at-first-unaffordable budget
    scan as :func:`select_random` runs over that order. The two
    baselines thus differ *only* in the sampling weights.
    """
    scores = np.asarray(scores, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    ids = list(range(len(scores))) if ids is None else list(ids)
    w = np.maximum(scores, 1e-12)
    u = np.maximum(rng.random(len(w)), np.finfo(np.float64).tiny)
    keys = np.log(u) / w
    order = np.argsort(-keys, kind="stable")
    chosen: list[int] = []
    remaining = float(budget)
    for j in order:
        if costs[j] > remaining:
            break
        chosen.append(int(j))
        remaining -= float(costs[j])
    ts, tc = _totals(chosen, scores, costs)
    return SelectionResult([ids[j] for j in chosen], ts, tc)


def select_score_prop_batch(scores: np.ndarray, costs: np.ndarray,
                            budgets: np.ndarray,
                            rngs: Sequence[np.random.Generator],
                            valid: np.ndarray | None = None
                            ) -> list[tuple[np.ndarray, float, float]]:
    """Batched :func:`select_score_prop` over T concurrent tasks sharing
    the client pool columns.

    Per task the Efraimidis–Spirakis keys are drawn exactly as the
    serial path does (``rng.random`` over that task's *valid* clients,
    in valid-position order), then the T budget scans collapse into one
    vectorized ``(T, n)`` sweep: stable argsort of the stacked keys
    (invalid clients get ``-inf`` keys and ``+inf`` costs, so they sort
    last and act as hard stops, same as never being visited) and the
    same left-fold remaining-budget recurrence as
    ``engine.greedy_knapsack_batch``. Selections are bit-identical to
    running the serial sampler per task with the same generators
    (asserted in tests/test_scale_plane.py).

    Returns per task ``(positions in pick order, total_score,
    total_cost)`` — positions index into ``scores``/``costs``.
    """
    scores = np.asarray(scores, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    budgets = np.atleast_1d(np.asarray(budgets, dtype=np.float64))
    T, n = budgets.shape[0], scores.shape[0]
    if valid is None:
        valid = np.ones((T, n), dtype=bool)
    else:
        valid = np.asarray(valid, dtype=bool)
    tiny = np.finfo(np.float64).tiny
    keys = np.full((T, n), -np.inf)
    w = np.maximum(scores, 1e-12)
    for t in range(T):                      # rng consumption stays serial
        cols = np.flatnonzero(valid[t])
        u = np.maximum(rngs[t].random(cols.size), tiny)
        keys[t, cols] = np.log(u) / w[cols]
    order = np.argsort(-keys, axis=1, kind="stable")      # (T, n)
    oc = np.where(np.take_along_axis(valid, order, axis=1),
                  costs[order], np.inf)
    rem = np.subtract.accumulate(
        np.concatenate([budgets[:, None], oc], axis=1), axis=1)[:, :-1]
    unaff = oc > rem
    first = np.where(unaff.any(axis=1), unaff.argmax(axis=1), n)
    out = []
    for t in range(T):
        picks = order[t, : first[t]]
        out.append((picks, float(scores[picks].sum()),
                    float(costs[picks].sum())))
    return out


# ---------------------------------------------------------------------------
# Full Stage-1 pipeline
# ---------------------------------------------------------------------------

def threshold_filter(profiles: Sequence[ClientProfile],
                     thresholds: np.ndarray | None) -> list[ClientProfile]:
    """Eq. (8d): keep clients whose thresholded criterion scores all meet
    the per-criterion minimums s_th (the paper thresholds s_1..s_9).

    Legacy dataclass path (per-profile loop); the array-native pipeline
    uses ``ClientPoolState.threshold_mask`` instead.
    """
    if thresholds is None:
        return list(profiles)
    th = np.asarray(thresholds, dtype=np.float64)
    kept = []
    for p in profiles:
        if np.all(p.scores[list(THRESHOLDED)] >= th[: len(THRESHOLDED)]):
            kept.append(p)
    return kept


def budget_floor(profiles: Sequence[ClientProfile] | ClientPoolState,
                 n_star: int) -> float:
    """Eq. (11): minimal budget = sum of the top-n* costs among filtered
    clients, guaranteeing the |S| >= n* constraint is satisfiable."""
    if isinstance(profiles, ClientPoolState):
        return profiles.budget_floor(n_star)
    costs = sorted((p.cost for p in profiles), reverse=True)
    return float(sum(costs[:n_star]))


def select_initial_pool(
    profiles: Sequence[ClientProfile] | ClientPoolState,
    budget: float,
    n_star: int = 1,
    thresholds: np.ndarray | None = None,
    method: str = "greedy",
    rng: np.random.Generator | None = None,
) -> SelectionResult:
    """Stage 1 end-to-end: filter -> feasibility -> knapsack (Eq. 12).

    Accepts a ``ClientPoolState`` (array-native fast path) or a profile
    list (converted once — thin adapter, same results). Filtering, score
    aggregation and the greedy knapsack are all masked array ops; no
    per-client Python work remains.
    """
    pool = (profiles if isinstance(profiles, ClientPoolState)
            else ClientPoolState.from_profiles(profiles))
    if method == "greedy" and isinstance(profiles, ClientPoolState):
        from . import device_pool
        if pool.n >= device_pool.HIERARCHICAL_MIN_N:
            return _select_initial_pool_hierarchical(
                pool, budget, n_star, thresholds)
    mask = pool.threshold_mask(thresholds)
    n_kept = int(mask.sum())
    if n_kept < n_star:
        return SelectionResult([], 0.0, 0.0, feasible=False,
                               note=f"only {n_kept} clients pass thresholds, need {n_star}")
    scores = pool.overall[mask]
    costs = pool.costs[mask]
    ids = pool.client_ids[mask].tolist()
    if method == "greedy":
        res = select_greedy(scores, costs, budget, ids)
    elif method == "dp":
        res = select_dp(scores, costs, budget, ids)
    elif method == "random":
        res = select_random(scores, costs, budget,
                            rng or np.random.default_rng(0), ids)
    elif method == "score_prop":
        res = select_score_prop(scores, costs, budget,
                                rng or np.random.default_rng(0), ids)
    else:
        raise ValueError(f"unknown method {method!r}")
    if len(res.selected) < n_star:
        res.feasible = False
        floor = pool.budget_floor(n_star, mask)
        res.note = (f"budget {budget} selects only {len(res.selected)} < n*={n_star} "
                    f"clients; Eq.(11) floor is {floor:.1f}")
    return res


def _select_initial_pool_hierarchical(
        pool: ClientPoolState, budget: float, n_star: int,
        thresholds: np.ndarray | None) -> SelectionResult:
    """Fleet-scale Stage 1: the two-level device-mirror greedy
    (``engine.hierarchical_greedy_knapsack``) behind the same contract
    as the flat path — identical ids in pick order, totals, and
    feasibility notes (asserted in tests/test_scale_plane.py). Entered
    from :func:`select_initial_pool` for ``method="greedy"`` pools at
    or above ``device_pool.HIERARCHICAL_MIN_N``; eligibility counting
    runs on the device mask, the Eq. (11) floor (infeasible path only)
    on the host mask."""
    rows, ts, tc, n_kept = engine.hierarchical_greedy_knapsack(
        pool, budget, thresholds)
    if n_kept < n_star:
        return SelectionResult(
            [], 0.0, 0.0, feasible=False,
            note=f"only {n_kept} clients pass thresholds, need {n_star}")
    res = SelectionResult(pool.client_ids[rows].tolist(), ts, tc)
    if len(res.selected) < n_star:
        res.feasible = False
        floor = pool.budget_floor(n_star, pool.threshold_mask(thresholds))
        res.note = (f"budget {budget} selects only {len(res.selected)} "
                    f"< n*={n_star} clients; Eq.(11) floor is {floor:.1f}")
    return res
