"""Selection / scheduling engine over ``ClientPoolState`` arrays.

The numpy hot path behind the control plane:

- ``greedy_knapsack``        — Stage-1 greedy (Eq. 12) as argsort +
  cumulative-sum prefix instead of a per-client Python loop. Bit-exact
  against ``selection.select_greedy_legacy`` (the remaining-budget
  sequence is reproduced with ``np.subtract.accumulate``, so even float
  rounding matches the sequential loop).
- ``mkp_pseudo_utility``     — the Toyoda scarcity-weighted scoring of
  *all* MKP candidates at once (``mkp.solve_mkp_greedy``).

Not ported yet: the batched multi-task greedy (ROADMAP.md Queue 1
item 2), the hierarchical fleet-scale greedy (item 6) and the device
MKP greedy (item 2). Pools of any size take the flat host greedy, whose
picks the reference holds equal to the hierarchical ones.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Stage 1: vectorized greedy knapsack
# ---------------------------------------------------------------------------

def greedy_order(scores: np.ndarray, costs: np.ndarray) -> np.ndarray:
    """Non-increasing score/cost ratio order (stable, like the legacy)."""
    ratio = np.asarray(scores, np.float64) / np.maximum(
        np.asarray(costs, np.float64), _EPS)
    return np.argsort(-ratio, kind="stable")


def greedy_knapsack(scores: np.ndarray, costs: np.ndarray, budget: float,
                    skip_unaffordable: bool = False
                    ) -> tuple[np.ndarray, float, float]:
    """Vectorized greedy (§VI-A). Returns ``(chosen, total_score,
    total_cost)`` with ``chosen`` positions in pick order — identical to
    the legacy Python loop on any input.

    Paper-faithful mode (``skip_unaffordable=False``): the scan stops at
    the first client whose cost exceeds the remaining budget, i.e. the
    selection is the longest affordable prefix of the ratio order. The
    remaining-budget sequence ``b - c0 - c1 - ...`` is evaluated with
    left-fold rounding (``np.subtract.accumulate``) so float behavior
    matches the sequential loop exactly.

    The skip variant keeps scanning for cheaper clients; that is an
    inherently sequential recurrence, run here over the presorted cost
    array with a suffix-min early exit.
    """
    scores = np.asarray(scores, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    order = greedy_order(scores, costs)
    oc = costs[order]
    n = oc.size
    if n == 0:
        return order[:0], 0.0, 0.0
    if not skip_unaffordable:
        # remaining[t] = budget - c0 - ... - c_{t-1}, folded left to right
        rem = np.subtract.accumulate(
            np.concatenate(([float(budget)], oc)))[:-1]
        unaff = oc > rem
        k = int(np.argmax(unaff)) if unaff.any() else n
        chosen = order[:k]
        return chosen, float(scores[chosen].sum()), float(costs[chosen].sum())
    # skip mode: sequential over the sorted order, but bail out as soon as
    # nothing further down can fit (suffix minimum of cost).
    sufmin = np.minimum.accumulate(oc[::-1])[::-1]
    remaining = float(budget)
    taken = np.zeros(n, dtype=bool)
    for t in range(n):
        if sufmin[t] > remaining:
            break
        c = oc[t]
        if c <= remaining:
            taken[t] = True
            remaining -= c
    chosen = order[taken]
    return chosen, float(scores[chosen].sum()), float(costs[chosen].sum())


def greedy_knapsack_batch(scores, costs, budgets, valid=None,
                          skip_unaffordable: bool = False,
                          backend: str = "auto"):
    """Batched Stage-1 greedy for multi-tenant serving (not ported)."""
    raise NotImplementedError(
        "the batched multi-task greedy is not ported yet: ROADMAP.md "
        "Queue 1 item 2")


# ---------------------------------------------------------------------------
# Stage 2: vectorized Toyoda pseudo-utility (MKP inner loop)
# ---------------------------------------------------------------------------

def mkp_pseudo_utility(values: np.ndarray, weights: np.ndarray,
                       residual: np.ndarray, selectable: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Scarcity-weighted utility of *all* candidates at once.

    ``util_j = v_j / (w_j · scarcity)`` with ``scarcity = 1/residual``;
    items that don't fit (or aren't selectable) score ``-inf``. This is
    the single source of truth for the greedy MKP scoring
    (``mkp.solve_mkp_greedy``).
    """
    scarcity = 1.0 / np.maximum(residual, _EPS)
    penalty = weights @ scarcity
    util = values / np.maximum(penalty, _EPS)
    fits = selectable & np.all(weights <= residual + _EPS, axis=1)
    return np.where(fits, util, -np.inf), fits
