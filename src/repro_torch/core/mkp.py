"""0-1 Multidimensional Knapsack (MKP) solver (paper §VI-B).

The paper solves its MKP instances with IBM CPLEX. CPLEX is not
available offline, so we implement the solver ourselves:

- ``solve_mkp_greedy`` — Toyoda-style pseudo-utility greedy: items are
  added in decreasing value per unit of *scarcity-weighted* capacity
  consumption, recomputed as knapsacks fill up; followed by a repair-free
  add pass and a 1-swap local search. This is the production path. The
  per-pick rescoring of all candidates is ``engine.mkp_pseudo_utility``
  (shared with the device path, see core/engine.py).
- ``solve_mkp_bnb`` — exact depth-first branch-and-bound with an
  LP-style fractional bound, for small instances; used by tests to bound
  the greedy's optimality gap and by the scheduler for tiny tail pools.

Conventions: ``values``(n,), ``weights``(n, m) [m knapsacks], and
``capacities``(m,). A selection S is feasible iff
``weights[S].sum(0) <= capacities`` elementwise and |S| <= max_size.
The subset-size *minimum* of problem (9b) is handled by the scheduler
(mandatory clients + complementary knapsacks), per the paper.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_EPS = 1e-12


@dataclasses.dataclass
class MKPResult:
    selected: list[int]
    value: float
    used: np.ndarray           # (m,) total weight per knapsack
    optimal: bool = False


def _check(values, weights, capacities):
    values = np.asarray(values, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    capacities = np.asarray(capacities, dtype=np.float64)
    if weights.ndim != 2 or weights.shape[0] != values.shape[0]:
        raise ValueError("weights must be (n_items, n_knapsacks)")
    if capacities.shape != (weights.shape[1],):
        raise ValueError("capacities must be (n_knapsacks,)")
    if np.any(weights < 0):
        raise ValueError("negative weights")
    return values, weights, capacities


def is_feasible(weights: np.ndarray, capacities: np.ndarray,
                selected: list[int], slack: float = 1e-9) -> bool:
    if not selected:
        return True
    return bool(np.all(weights[selected].sum(axis=0) <= capacities + slack))


# ---------------------------------------------------------------------------
# Greedy + local search
# ---------------------------------------------------------------------------

def solve_mkp_greedy(values, weights, capacities, max_size: int | None = None,
                     local_search: bool = True) -> MKPResult:
    values, weights, capacities = _check(values, weights, capacities)
    n, m = weights.shape
    max_size = n if max_size is None else int(max_size)

    selected: list[int] = []
    used = np.zeros(m)
    in_sel = np.zeros(n, dtype=bool)

    # -- pseudo-utility greedy (recompute scarcity each pick) --
    # The whole candidate set is rescored at once per pick; the scoring
    # formula lives in engine.mkp_pseudo_utility (one source of truth for
    # the numpy path; the device path's kernel computes the same formula).
    from .engine import mkp_pseudo_utility
    while len(selected) < max_size:
        residual = capacities - used
        util, fits = mkp_pseudo_utility(values, weights, residual, ~in_sel)
        if not np.any(fits):
            break
        j = int(np.argmax(util))
        selected.append(j)
        in_sel[j] = True
        used += weights[j]

    # -- 1-swap local search: replace one selected with one unselected of
    # higher value if feasible; repeat until no improvement --
    if local_search and selected:
        improved = True
        order_out = np.argsort(values)  # try swapping low-value items out first
        while improved:
            improved = False
            for j_out in order_out:
                if not in_sel[j_out]:
                    continue
                residual = capacities - used + weights[j_out]
                cand = ~in_sel & (values > values[j_out] + _EPS) \
                    & np.all(weights <= residual + _EPS, axis=1)
                if np.any(cand):
                    j_in = int(np.argmax(np.where(cand, values, -np.inf)))
                    in_sel[j_out] = False
                    in_sel[j_in] = True
                    used = used - weights[j_out] + weights[j_in]
                    selected[selected.index(int(j_out))] = j_in
                    improved = True
            # greedy add pass after swaps freed capacity
            while len(selected) < max_size:
                residual = capacities - used
                fits = ~in_sel & np.all(weights <= residual + _EPS, axis=1)
                if not np.any(fits):
                    break
                j = int(np.argmax(np.where(fits, values, -np.inf)))
                selected.append(j)
                in_sel[j] = True
                used += weights[j]
                improved = True

    return MKPResult(sorted(selected), float(values[selected].sum()) if selected else 0.0,
                     used, optimal=False)


# ---------------------------------------------------------------------------
# Exact branch and bound (small instances / tests)
# ---------------------------------------------------------------------------

def _fractional_bound(values, weights, residual, order, start, max_items):
    """Upper bound for the remaining items ``order[start:]``.

    min of two valid relaxations:
      (a) the LP (fractional) bound of the single *tightest* knapsack,
          with that knapsack's items taken in its own density order
          (any multi-constraint optimum satisfies each single constraint);
      (b) the cardinality bound: sum of the ``max_items`` largest values.
    """
    rest = order[start:]
    if not rest or max_items <= 0:
        return 0.0
    rest_vals = values[rest]
    # (b) cardinality bound
    if len(rest) > max_items:
        card = float(np.sort(rest_vals)[-max_items:].sum())
    else:
        card = float(rest_vals.sum())
    # (a) single-knapsack fractional bound on the tightest knapsack
    denom = np.maximum(weights.mean(axis=0), _EPS)
    k = int(np.argmin(residual / denom))
    wk = weights[rest, k]
    dens = rest_vals / np.maximum(wk, _EPS)
    by_density = np.argsort(-dens, kind="stable")
    cap = residual[k]
    frac = 0.0
    for idx in by_density:
        w = wk[idx]
        if w <= _EPS or w <= cap:
            frac += rest_vals[idx]
            cap -= w
        else:
            frac += rest_vals[idx] * (cap / w)
            break
    return min(card, frac)


def solve_mkp_bnb(values, weights, capacities, max_size: int | None = None,
                  node_limit: int = 2_000_000) -> MKPResult:
    values, weights, capacities = _check(values, weights, capacities)
    n, m = weights.shape
    max_size = n if max_size is None else int(max_size)
    # order by single-knapsack density for bounding
    density = values / np.maximum(weights.sum(axis=1), _EPS)
    order = list(np.argsort(-density, kind="stable"))

    best_val = -1.0
    best_sel: list[int] = []
    nodes = 0

    # seed with greedy for pruning power
    g = solve_mkp_greedy(values, weights, capacities, max_size)
    best_val, best_sel = g.value, list(g.selected)

    stack = [(0, 0.0, capacities.copy(), [])]  # (depth, value, residual, chosen)
    while stack:
        nodes += 1
        if nodes > node_limit:
            break
        depth, val, residual, chosen = stack.pop()
        if val > best_val:
            best_val, best_sel = val, list(chosen)
        if depth >= n or len(chosen) >= max_size:
            continue
        ub = val + _fractional_bound(values, weights, residual, order, depth,
                                     max_size - len(chosen))
        if ub <= best_val + _EPS:
            continue
        j = order[depth]
        # branch: exclude j (pushed first -> explored last), include j
        stack.append((depth + 1, val, residual, chosen))
        if np.all(weights[j] <= residual + _EPS):
            stack.append((depth + 1, val + values[j], residual - weights[j],
                          chosen + [int(j)]))

    used = weights[best_sel].sum(axis=0) if best_sel else np.zeros(m)
    return MKPResult(sorted(best_sel), float(best_val), used,
                     optimal=nodes <= node_limit)


def solve_mkp(values, weights, capacities, max_size: int | None = None,
              exact_threshold: int = 18, backend: str = "numpy",
              device=None) -> MKPResult:
    """Dispatch: exact B&B for tiny instances, greedy+LS otherwise.

    ``backend="device"`` (the reference's ``"jax"``) routes large
    instances through ``engine.solve_mkp_greedy_device`` on ``device``
    (None -> ``cuda``): the greedy loop over the ``mkp_utility`` kernel,
    greedy phase only, no local search.
    """
    if backend not in ("numpy", "device"):
        raise ValueError(f"unknown MKP backend {backend!r}: the port's "
                         "backends are 'numpy' and 'device' (the "
                         "reference's 'jax')")
    values = np.asarray(values, dtype=np.float64)
    if values.shape[0] <= exact_threshold:
        return solve_mkp_bnb(values, weights, capacities, max_size)
    if backend == "device":
        from .engine import solve_mkp_greedy_device
        mask, used = solve_mkp_greedy_device(values, weights, capacities,
                                             max_size, device=device)
        sel = np.flatnonzero(mask)
        val = float(values[sel].sum()) if sel.size else 0.0
        return MKPResult([int(j) for j in sel], val,
                         np.asarray(used, dtype=np.float64), optimal=False)
    return solve_mkp_greedy(values, weights, capacities, max_size)
