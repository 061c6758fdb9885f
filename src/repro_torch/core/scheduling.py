"""Stage 2: per-round client scheduling (paper §V-B, §VI-B, Algorithm 1).

``generate_subsets`` implements Algorithm 1 *Generate Subsets*: the pool
is partitioned into subsets — one per round of a scheduling period — by
solving a sequence of MKPs (one knapsack per class label, client
histograms as weights), with the paper's two heuristics:

- **Nid improvement**: if a subset's integrated Nid exceeds a threshold,
  previously-selected clients that still have selection budget (< x*)
  and data in the under-filled classes are added back as *compensation*
  candidates and the subset is re-selected.
- **Complementary knapsacks**: to enforce a minimum subset size (or to
  absorb a too-small tail pool), the already-chosen clients become
  *mandatory*; a second MKP is solved over the other eligible clients
  with capacities reduced by the mandatory fill (Fig. 2).

The outer loop is inherently sequential (each round's MKP depends on the
previous rounds' picks), but *all* per-iteration work — integrated-Nid,
under-fill detection, compensation eligibility, candidate assembly —
runs as masked array ops over the pool's stacked ``(n, c)`` histogram
matrix (``ClientPoolState`` columns). The pre-refactor dict/loop
implementation is preserved as ``generate_subsets_legacy``; both produce
identical schedules (tests/test_engine.py) and both are property-checked
by tests/test_fairness.py.

Guarantees (paper §VII, checked by tests/test_fairness.py):
  every pooled client appears in >= 1 subset; no client appears in more
  than x* subsets; subset sizes lie in [min(n-δ, pool tail), n+δ].
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .criteria import nid
from .mkp import solve_mkp, MKPResult
from .pool import ClientPoolState


@dataclasses.dataclass
class ScheduleResult:
    subsets: list[list[int]]            # client ids per round
    nids: list[float]                   # integrated Nid per subset
    counts: dict[int, int]              # participation count per client id
    capacities: np.ndarray              # knapsack capacities used

    @property
    def num_rounds(self) -> int:
        return len(self.subsets)

    def max_nid(self) -> float:
        return max(self.nids) if self.nids else 0.0


def subset_nid(histograms: dict[int, np.ndarray], subset: Sequence[int]) -> float:
    """Nid of the 'integrated' dataset: Nid(sum of member histograms)."""
    if not subset:
        return 1.0
    h = np.sum([histograms[k] for k in subset], axis=0)
    return float(nid(h))


def default_capacities(histograms: dict[int, np.ndarray], n: int) -> np.ndarray:
    """Paper §VIII-C: one capacity for all knapsacks, set so that across
    the T = |S|/n expected rounds the knapsacks can accommodate the data
    of the maximum (most abundant) class in the pool."""
    total = np.sum(list(histograms.values()), axis=0)
    T = max(1, int(np.ceil(len(histograms) / max(n, 1))))
    cap = float(np.ceil(total.max() / T))
    return np.full(total.shape, cap)


def default_capacities_arrays(H: np.ndarray, n: int) -> np.ndarray:
    """Array form of :func:`default_capacities` over a stacked (P, c)
    histogram matrix."""
    total = H.sum(axis=0)
    T = max(1, int(np.ceil(H.shape[0] / max(n, 1))))
    cap = float(np.ceil(total.max() / T))
    return np.full(total.shape, cap)


# ---------------------------------------------------------------------------
# Array-native Algorithm 1 (the production path)
# ---------------------------------------------------------------------------

def _as_pool_arrays(histograms) -> tuple[np.ndarray, np.ndarray]:
    """Adapter: dict / ClientPoolState / (ids, H) -> (ids, H) arrays with
    rows in ascending-id order (the algorithm's canonical order)."""
    if isinstance(histograms, ClientPoolState):
        order = np.argsort(histograms.client_ids, kind="stable")
        return histograms.client_ids[order], histograms.histograms[order]
    if isinstance(histograms, tuple):
        ids, H = histograms
        ids = np.asarray(ids, dtype=np.int64)
        H = np.asarray(H, dtype=np.float64)
        order = np.argsort(ids, kind="stable")
        return ids[order], H[order]
    ids = np.array(sorted(histograms.keys()), dtype=np.int64)
    if ids.size == 0:
        return ids, np.zeros((0, 1))
    H = np.stack([np.asarray(histograms[int(k)], dtype=np.float64)
                  for k in ids])
    return ids, H


def _solve_rows(rows: np.ndarray, H: np.ndarray, capacities: np.ndarray,
                max_size: int, backend: str) -> np.ndarray:
    """One MKP (Eq. 13) over the candidate ``rows``: value = |h|_1,
    weights = h. Returns the chosen rows (subset of ``rows``)."""
    if rows.size == 0:
        return rows
    W = H[rows]
    v = W.sum(axis=1)
    res: MKPResult = solve_mkp(v, W, capacities, max_size=max_size,
                               backend=backend)
    return rows[np.asarray(res.selected, dtype=np.int64)] if res.selected \
        else rows[:0]


def _complementary_rows(mandatory: np.ndarray, candidates: np.ndarray,
                        H: np.ndarray, capacities: np.ndarray,
                        max_extra: int, backend: str) -> np.ndarray:
    """Complementary-knapsacks trick (Fig. 2): capacities minus the
    mandatory fill become the new capacities; fill from ``candidates``."""
    fill = H[mandatory].sum(axis=0) if mandatory.size else \
        np.zeros_like(capacities)
    residual = np.maximum(capacities - fill, 0.0)
    extra = _solve_rows(candidates, H, residual, max_extra, backend)
    return np.concatenate([mandatory, extra])


def generate_subsets(
    histograms: Mapping[int, np.ndarray] | ClientPoolState |
                tuple[np.ndarray, np.ndarray],
    n: int,
    delta: int,
    x_star: int = 3,
    nid_threshold: float = 0.35,
    fill_frac: float = 0.6,
    capacities: np.ndarray | None = None,
    backend: str = "numpy",
) -> ScheduleResult:
    """Algorithm 1 *Generate Subsets*, array-native.

    Args:
      histograms: the client pool S — a ``ClientPoolState``, an
        ``(ids, H)`` array pair, or the legacy ``client_id -> (c,)``
        dict (adapted to arrays once).
      n, delta: desired subset size and tolerance (sizes in [n-δ, n+δ]).
      x_star: max times a client may be selected per scheduling period.
      nid_threshold: trigger for the Nid-improvement pass.
      fill_frac: a knapsack is 'under-filled' when below this fraction.
      capacities: optional explicit knapsack capacities (else §VIII-C rule).
      backend: MKP backend ("numpy" greedy+LS; "jax" is not ported yet).

    Produces schedules identical to :func:`generate_subsets_legacy`
    (with the default backend); only the per-iteration bookkeeping is
    vectorized.
    """
    ids, H = _as_pool_arrays(histograms)
    P = ids.size
    if P == 0:
        return ScheduleResult([], [], {}, np.zeros(0))
    caps = default_capacities_arrays(H, n) if capacities is None \
        else np.asarray(capacities, dtype=np.float64)
    sizes = H.sum(axis=1)

    counts = np.zeros(P, dtype=np.int64)
    remaining = np.ones(P, dtype=bool)
    subsets_rows: list[np.ndarray] = []
    min_size, max_size = max(1, n - delta), n + delta

    def eligible_compensation(exclude: np.ndarray) -> np.ndarray:
        # previously-selected rows with selection budget left
        return ~remaining & ~exclude & (counts < x_star)

    while remaining.any():
        rem_rows = np.flatnonzero(remaining)        # ascending id order
        if rem_rows.size >= min_size:
            sel = _solve_rows(rem_rows, H, caps, max_size, backend)
            if sel.size == 0:
                # no single client fits the capacities: force the smallest
                # remaining client so the algorithm always progresses.
                sel = rem_rows[[int(np.argmin(sizes[rem_rows]))]]
            # -- Nid improvement (compensation clients) --
            fill = H[sel].sum(axis=0)
            sel_nid = float(nid(fill))
            if sel_nid > nid_threshold:
                under = fill < fill_frac * caps
                if under.any():
                    in_sel = np.zeros(P, dtype=bool)
                    in_sel[sel] = True
                    comp = eligible_compensation(in_sel) & \
                        (H[:, under].sum(axis=1) > 0)
                    if comp.any():
                        cand = np.flatnonzero(remaining | comp)
                        resel = _solve_rows(cand, H, caps, max_size, backend)
                        # keep the re-selection only if it covers >=1
                        # remaining client (progress) and improves Nid
                        if (remaining[resel].any()
                                and float(nid(H[resel].sum(axis=0))) < sel_nid):
                            sel = resel
            # -- enforce minimum size via mandatory clients + complementary --
            if sel.size < min_size:
                in_sel = np.zeros(P, dtype=bool)
                in_sel[sel] = True
                pool2 = rem_rows[~in_sel[rem_rows]]
                comp = np.flatnonzero(eligible_compensation(in_sel))
                candidates = np.concatenate([pool2, comp])
                sel = _complementary_rows(sel, candidates, H, caps,
                                          max_size - sel.size, backend)
                # if still short, pad greedily with smallest remaining
                # clients (size constraint beats Nid, per the paper)
                if sel.size < min_size:
                    in_sel = np.zeros(P, dtype=bool)
                    in_sel[sel] = True
                    pad = pool2[~in_sel[pool2]]
                    pad = pad[np.argsort(sizes[pad], kind="stable")]
                    need = min_size - sel.size
                    sel = np.concatenate([sel, pad[:need]])
        else:
            # too few clients left: select all + complementary knapsacks
            sel = rem_rows
            in_sel = np.zeros(P, dtype=bool)
            in_sel[sel] = True
            comp = np.flatnonzero(eligible_compensation(in_sel))
            if sel.size < max_size and comp.size:
                sel = _complementary_rows(sel, comp, H, caps,
                                          max_size - sel.size, backend)

        subsets_rows.append(np.sort(sel))
        counts[sel] += 1
        remaining[sel] = False

    nids = [float(nid(H[s].sum(axis=0))) if s.size else 1.0
            for s in subsets_rows]
    subsets = [ids[s].tolist() for s in subsets_rows]
    count_map = {int(ids[i]): int(counts[i]) for i in range(P)}
    return ScheduleResult(subsets, nids, count_map, caps)


# ---------------------------------------------------------------------------
# Legacy dict/loop implementation (reference for equivalence + fairness)
# ---------------------------------------------------------------------------

def _solve_subset(pool_ids: list[int], histograms, capacities, max_size) -> list[int]:
    """One MKP (Eq. 13): value = |h_k|_1 (client data size), weights = h_k."""
    if not pool_ids:
        return []
    W = np.stack([histograms[k] for k in pool_ids])
    v = W.sum(axis=1)
    res: MKPResult = solve_mkp(v, W, capacities, max_size=max_size)
    return [pool_ids[j] for j in res.selected]


def _underfilled(histograms, subset, capacities, frac: float) -> np.ndarray:
    fill = np.sum([histograms[k] for k in subset], axis=0) if subset else \
        np.zeros_like(capacities)
    return fill < frac * capacities


def _complementary(mandatory: list[int], candidates: list[int], histograms,
                   capacities, max_extra: int) -> list[int]:
    """Complementary-knapsacks trick (Fig. 2): capacities minus the
    mandatory fill become the new knapsack capacities; select from
    ``candidates`` to fill the available space."""
    fill = np.sum([histograms[k] for k in mandatory], axis=0) if mandatory else \
        np.zeros_like(capacities)
    residual = np.maximum(capacities - fill, 0.0)
    extra = _solve_subset(candidates, histograms, residual, max_extra)
    return mandatory + extra


def generate_subsets_legacy(
    histograms: dict[int, np.ndarray],
    n: int,
    delta: int,
    x_star: int = 3,
    nid_threshold: float = 0.35,
    fill_frac: float = 0.6,
    capacities: np.ndarray | None = None,
) -> ScheduleResult:
    """Pre-refactor Algorithm 1 over ``dict`` histograms and Python sets.

    Kept as the reference the array-native :func:`generate_subsets` is
    tested against; not a production path.
    """
    ids = sorted(histograms.keys())
    if not ids:
        return ScheduleResult([], [], {}, np.zeros(0))
    histograms = {k: np.asarray(histograms[k], dtype=np.float64) for k in ids}
    caps = default_capacities(histograms, n) if capacities is None \
        else np.asarray(capacities, dtype=np.float64)

    counts = {k: 0 for k in ids}
    remaining = set(ids)
    subsets: list[list[int]] = []
    min_size, max_size = max(1, n - delta), n + delta

    def eligible_compensation(exclude: set[int]) -> list[int]:
        # previously-selected clients with selection budget left
        return [k for k in ids
                if k not in remaining and k not in exclude and counts[k] < x_star]

    while remaining:
        rem_list = sorted(remaining)
        if len(rem_list) >= min_size:
            subset = _solve_subset(rem_list, histograms, caps, max_size)
            if not subset:
                # no single client fits the capacities: force the smallest
                # remaining client so the algorithm always progresses.
                smallest = min(rem_list, key=lambda k: histograms[k].sum())
                subset = [smallest]
            # -- Nid improvement (compensation clients) --
            if subset_nid(histograms, subset) > nid_threshold:
                under = _underfilled(histograms, subset, caps, fill_frac)
                if np.any(under):
                    comp = [k for k in eligible_compensation(set(subset))
                            if histograms[k][under].sum() > 0]
                    if comp:
                        resel = _solve_subset(sorted(set(rem_list) | set(comp)),
                                              histograms, caps, max_size)
                        # keep the re-selection only if it covers >=1 remaining
                        # client (progress) and improves Nid
                        if (set(resel) & remaining
                                and subset_nid(histograms, resel)
                                < subset_nid(histograms, subset)):
                            subset = resel
            # -- enforce minimum size via mandatory clients + complementary --
            if len(subset) < min_size:
                pool2 = [k for k in rem_list if k not in subset]
                comp = eligible_compensation(set(subset))
                candidates = pool2 + comp
                subset = _complementary(subset, candidates, histograms, caps,
                                        max_extra=max_size - len(subset))
                # if still short, pad greedily with smallest remaining clients
                # (size constraint beats Nid, per the paper's relaxation)
                for k in sorted(pool2, key=lambda k: histograms[k].sum()):
                    if len(subset) >= min_size:
                        break
                    if k not in subset:
                        subset.append(k)
        else:
            # too few clients left: select all + complementary knapsacks
            subset = list(rem_list)
            comp = eligible_compensation(set(subset))
            if len(subset) < max_size and comp:
                subset = _complementary(subset, comp, histograms, caps,
                                        max_extra=max_size - len(subset))

        subsets.append(sorted(subset))
        for k in subset:
            counts[k] += 1
        remaining -= set(subset)

    nids = [subset_nid(histograms, s) for s in subsets]
    return ScheduleResult(subsets, nids, counts, caps)


def random_subsets(histograms: dict[int, np.ndarray], n: int,
                   rng: np.random.Generator) -> ScheduleResult:
    """Baseline: random partition into subsets of size n (paper Fig. 4
    right half / 'random selection' learning curves)."""
    ids = list(histograms.keys())
    rng.shuffle(ids)
    subsets = [sorted(ids[i:i + n]) for i in range(0, len(ids), n)]
    nids = [subset_nid({k: np.asarray(histograms[k], dtype=np.float64)
                        for k in histograms}, s) for s in subsets]
    counts = {k: 1 for k in histograms}
    return ScheduleResult(subsets, nids, counts, np.zeros(0))


def participation_weights(histograms: dict[int, np.ndarray],
                          subset: Sequence[int]) -> np.ndarray:
    """FedAvg p_k = n_k / sum n_k over the round's subset (paper §III)."""
    sizes = np.array([np.sum(histograms[k]) for k in subset], dtype=np.float64)
    return sizes / np.maximum(sizes.sum(), 1e-12)
