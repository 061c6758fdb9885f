"""Fairness metrics and guarantee checks (paper §VII).

The paper's fairness guarantee has two parts:
  1. every client meeting the minimum requirements is *considered* for
     the pool (threshold filter keeps them in the optimization);
  2. every pooled client participates in >= 1 round per scheduling
     period, and over-participation is bounded by x*.

This module provides checkable predicates for both plus standard
quantitative fairness measures used in the FL-fairness literature
(Jain's index, participation-count variance) so experiments can report
*how* fair a schedule is, not only that the guarantee holds.
"""
from __future__ import annotations

import numpy as np

from .scheduling import ScheduleResult


def coverage(result: ScheduleResult, pool_ids) -> bool:
    """Part 2a: every pooled client selected at least once."""
    return all(result.counts.get(k, 0) >= 1 for k in pool_ids)


def bounded_participation(result: ScheduleResult, x_star: int) -> bool:
    """Part 2b: no client selected more than x* times."""
    return all(v <= x_star for v in result.counts.values())


def participation_counts(result: ScheduleResult) -> np.ndarray:
    return np.array(sorted(result.counts.values()), dtype=np.float64)


def jain_index(counts: np.ndarray) -> float:
    """Jain's fairness index in (0, 1]; 1 = perfectly equal counts."""
    c = np.asarray(counts, dtype=np.float64)
    if c.size == 0 or np.all(c == 0):
        return 1.0
    return float((c.sum() ** 2) / (c.size * (c ** 2).sum()))


def over_selection_fraction(result: ScheduleResult) -> float:
    """Fraction of clients selected more than once (paper §VII argues this
    stays small, controlled by δ and x*)."""
    counts = participation_counts(result)
    if counts.size == 0:
        return 0.0
    return float(np.mean(counts > 1))


def selection_chance_ratio(selected_counts: np.ndarray,
                           trials: int) -> np.ndarray:
    """Part 1 empirical check: per-client probability of entering the pool
    across repeated stage-1 runs (with resampled costs/scores)."""
    return np.asarray(selected_counts, dtype=np.float64) / max(trials, 1)


def fairness_report(result: ScheduleResult, pool_ids, x_star: int) -> dict:
    counts = participation_counts(result)
    return {
        "coverage": coverage(result, pool_ids),
        "bounded": bounded_participation(result, x_star),
        "jain_index": jain_index(counts),
        "over_selection_fraction": over_selection_fraction(result),
        "mean_count": float(counts.mean()) if counts.size else 0.0,
        "max_count": int(counts.max()) if counts.size else 0,
        "rounds": result.num_rounds,
        "max_nid": result.max_nid(),
    }
