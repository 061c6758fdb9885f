"""Batched selection / scheduling engine over ``ClientPoolState`` arrays.

This module is the array-native hot path behind the control plane:

- ``greedy_knapsack``        — Stage-1 greedy (Eq. 12) as argsort +
  cumulative-sum prefix instead of a per-client Python loop. Bit-exact
  against ``selection.select_greedy_legacy`` (the remaining-budget
  sequence is reproduced with ``np.subtract.accumulate``, so even float
  rounding matches the sequential loop).
- ``greedy_knapsack_batch``  — the same greedy over many concurrent
  ``TaskRequest`` budgets/threshold masks (multi-tenant serving), in
  numpy or batched on the device.
- ``hierarchical_greedy_knapsack`` — stage 1 at fleet scale: per-shard
  frontiers over the device pool mirror (``segmented_topk`` kernel),
  then the exact greedy on the host over the candidates.
- ``mkp_pseudo_utility``     — the Toyoda scarcity-weighted scoring of
  *all* MKP candidates at once (shared with ``mkp.solve_mkp_greedy`` so
  the two paths cannot drift).
- ``solve_mkp_greedy_device`` — the whole MKP greedy of one solve on the
  device, one launch of ``kernels.ops.mkp_greedy`` (the CUDA kernel; its
  plain version on the CPU).

Data flow: callers hold a ``ClientPoolState``; every function here takes
plain arrays (columns of that state) and returns arrays/masks, and never
materializes ``ClientProfile`` objects.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import mkp_utility as _mkp_kernel
from ..kernels import ops
from .criteria import overall_score

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


def _greedy_batch_device(scores, costs, budgets, valid, device,
                         skip_unaffordable: bool = False):
    """(T,) budgets x (T, n) validity -> (T, n) selection masks, on the
    device in f32: per task a stable descending sort of the masked
    ratio, then the paper's prefix rule (stop at the first client whose
    cost exceeds the budget left), or with ``skip_unaffordable`` the
    skip rule (pass over that client and go on)."""
    dev = resolve_device(device)
    s = torch.from_numpy(np.asarray(scores, np.float32)).to(dev)
    c = torch.from_numpy(np.asarray(costs, np.float32)).to(dev)
    b = torch.from_numpy(np.asarray(budgets, np.float32)).to(dev)
    v = torch.from_numpy(np.ascontiguousarray(valid, dtype=np.bool_)).to(dev)
    T, n = v.shape
    neg = torch.tensor(float("-inf"), device=dev)
    ratio = torch.where(v, s / c.clamp_min(_EPS), neg)
    order = torch.sort(ratio, dim=1, descending=True, stable=True).indices
    # invalid clients sort last; infinite cost makes them hard stops
    sv = v.gather(1, order)
    oc = torch.where(sv, c[order], -neg)
    if skip_unaffordable:
        take = _skip_take(oc, sv, b)
    else:
        spent = torch.cat([torch.zeros(T, 1, device=dev),
                           torch.cumsum(oc, dim=1)[:, :-1]], dim=1)
        stop = oc > b[:, None] - spent
        first = torch.where(stop.any(dim=1),
                            stop.to(torch.int32).argmax(dim=1),
                            torch.full((T,), n, device=dev))
        take = sv & (torch.arange(n, device=dev)[None, :] < first[:, None])
    return torch.zeros_like(v).scatter_(1, order, take).cpu().numpy()


def _skip_take(oc, sv, budgets):
    """The skip rule over ratio-sorted costs ``oc`` (T, n) f32 (inf where
    not valid): a client is taken when its cost fits the budget left.
    Between two skipped clients every client fits, so each pass takes
    the longest affordable run from a task's cursor by a cumulative sum,
    skips the client that ends it and moves the cursor past it; a task
    is done when no client from its cursor on is cheap enough (the
    suffix minimum, the numpy path's early exit). One pass per skipped
    client, each O(T n), vectorised over tasks."""
    T, n = oc.shape
    dev = oc.device
    pos = torch.arange(n, device=dev)[None, :]
    inf = torch.full((T, 1), float("inf"), device=dev)
    sufmin = torch.cat([torch.flip(torch.cummin(torch.flip(oc, [1]), 1).values,
                                   [1]), inf], dim=1)        # (T, n + 1)
    cursor = torch.zeros(T, 1, dtype=torch.int64, device=dev)
    left = budgets.clone()
    take = torch.zeros_like(sv)
    while True:
        live = sufmin.gather(1, cursor)[:, 0] <= left
        if not bool(live.any()):
            return take
        avail = sv & (pos >= cursor) & live[:, None]
        run = torch.where(avail, oc, 0.0)
        over = avail & (torch.cumsum(run, dim=1) > left[:, None])
        first = torch.where(over.any(dim=1),
                            over.to(torch.int32).argmax(dim=1),
                            torch.full((T,), n, device=dev))[:, None]
        got = avail & (pos < first)
        take |= got
        left = left - torch.where(got, oc, 0.0).sum(dim=1)
        cursor = torch.where(live[:, None], (first + 1).clamp_max(n), cursor)


def greedy_knapsack_batch(scores: np.ndarray, costs: np.ndarray,
                          budgets: np.ndarray,
                          valid: np.ndarray | None = None,
                          skip_unaffordable: bool = False,
                          backend: str = "auto", device=None):
    """Batched Stage-1 greedy for multi-tenant serving.

    Every concurrent task shares the client pool, hence the score/cost
    ratio *order*: the numpy batch reduces to ONE argsort plus a
    ``(T, n)`` masked cumulative sum — per-task work is O(n), not
    O(n log n), and fully vectorized over tasks. ``backend="device"``
    instead sorts and scans every task on the device (``device``, None ->
    ``cuda``), the reference's jit+vmap ``backend="jax"``. ``"auto"``
    is numpy, the reference's own choice off the TPU: it is exact, and
    the same call gives the same picks with or without CUDA.

    Args:
      scores, costs: (n,) shared client pool columns.
      budgets: (T,) one budget per concurrent task.
      valid: optional (T, n) per-task eligibility (threshold masks).

    Returns ``(masks, total_scores, total_costs)`` with shapes
    ``(T, n), (T,), (T,)`` as numpy arrays. With the numpy backend,
    selections are bit-exact against running the single-task greedy per
    task over its valid clients; the device backend ranks and sums in
    float32 (ratio ties / rounding may differ at the margin; on
    integer costs the sums are exact), and its totals are taken on the
    host in float64.
    """
    if backend == "auto":
        backend = "numpy"
    if backend not in ("numpy", "device"):
        raise ValueError(f"unknown backend {backend!r}: the port's backends "
                         "are 'numpy' and 'device' (the reference's 'jax')")
    scores = np.asarray(scores, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    budgets = np.atleast_1d(np.asarray(budgets, dtype=np.float64))
    T, n = budgets.shape[0], scores.shape[0]
    if valid is None:
        valid = np.ones((T, n), dtype=bool)
    else:
        valid = np.asarray(valid, dtype=bool)
    if backend == "device":
        masks = _greedy_batch_device(scores, costs, budgets, valid, device,
                                     skip_unaffordable)
        return masks, masks @ scores, masks @ costs
    if skip_unaffordable:
        # sequential recurrence per task; no shared-prefix shortcut
        masks = np.zeros((T, n), dtype=bool)
        for t in range(T):
            cols = np.flatnonzero(valid[t])
            chosen, _, _ = greedy_knapsack(scores[cols], costs[cols],
                                           budgets[t], skip_unaffordable=True)
            masks[t, cols[chosen]] = True
        return masks, masks @ scores, masks @ costs
    order = greedy_order(scores, costs)
    oc = costs[order]                                  # (n,)
    ov = valid[:, order]                               # (T, n)
    # Reproduce the single-task greedy's left-fold remaining-budget
    # sequence per row (budget - c0 - c1 - ..., rounded at every step;
    # invalid clients subtract exactly 0.0), so selections are bit-exact
    # against greedy_knapsack even when partial sums round differently
    # than a cumsum-vs-budget comparison would.
    rem = np.subtract.accumulate(
        np.concatenate([budgets[:, None], np.where(ov, oc, 0.0)], axis=1),
        axis=1)[:, :-1]                                # (T, n) before each pick
    viol = ov & (oc > rem)
    first = np.where(viol.any(axis=1), viol.argmax(axis=1), n)
    take = ov & (np.arange(n) < first[:, None])
    masks = np.zeros((T, n), dtype=bool)
    masks[:, order] = take
    return masks, masks @ scores, masks @ costs


# ---------------------------------------------------------------------------
# Stage 1 at fleet scale: hierarchical two-level greedy
# ---------------------------------------------------------------------------

def _flat_pool_greedy(pool, budget: float, thresholds
                      ) -> tuple[np.ndarray, float, float, int]:
    """Host flat path over a ``ClientPoolState``: threshold mask ->
    greedy over kept rows -> global row indices in pick order."""
    mask = pool.threshold_mask(thresholds)
    rows_kept = np.flatnonzero(mask)
    chosen, ts, tc = greedy_knapsack(pool.overall[rows_kept],
                                     pool.costs[rows_kept], budget)
    return rows_kept[chosen], ts, tc, int(rows_kept.size)


def hierarchical_greedy_knapsack(pool, budget: float,
                                 thresholds: np.ndarray | None = None,
                                 *, mirror=None, shard_cap: int | None = None,
                                 stats: dict | None = None
                                 ) -> tuple[np.ndarray, float, float, int]:
    """Two-level Stage-1 greedy over the device pool mirror (fleet
    scale: 1M–10M clients).

    Level 1 (device, f32): eligibility mask + score/cost ratios over the
    ``(S, C)`` sharded mirror, then a per-shard top-``F`` frontier via
    the ``segmented_topk`` kernel — O(n) streaming work, no full-pool
    argsort. Level 2 (host, f64): the exact paper greedy over the
    ``<= S*F`` surviving candidates, re-ranked with the host pool's f64
    scores/costs and the flat path's stable tie-break (ratio ties break
    toward the lower global row). The frontier escalates (``F *= 2``)
    whenever a clipped shard could still contribute — i.e. the budget
    scan consumed a clipped shard's entire frontier, or never hit a
    stop — so on termination the result provably matches the flat
    greedy on the f32-frontier candidate set (membership itself is
    decided in f32).

    Degenerate budgets that would select a large fraction of the pool
    (frontier ~ pool) fall back to the flat host path.

    The mirror is the pool's cached one (``pool.device_mirror``: on its
    device, else ``cuda``) unless ``mirror`` is given. Returns ``(rows,
    total_score, total_cost, n_valid)`` with ``rows`` global pool rows in
    pick order. ``stats``, if given, is filled with
    path/frontier/escalation counters.
    """
    if mirror is None:
        mirror = pool.device_mirror(shard_cap=shard_cap)
    else:
        mirror.sync(pool)
    valid = mirror.valid_mask(thresholds)
    counts, cost_sum = mirror.shard_stats(valid)
    n_valid = int(counts.sum())
    if stats is None:
        stats = {}
    stats.update(path="frontier", frontier=0, escalations=0,
                 candidates=0, shards=mirror.num_shards)
    if n_valid == 0:
        return np.zeros(0, np.int64), 0.0, 0.0, 0
    S = mirror.num_shards
    max_count = int(counts.max())
    budget = float(budget)
    # Frontier sizing: expected picks if the budget were spent at the
    # mean valid cost, spread over shards, with 4x headroom for skew.
    k_est = budget / max(cost_sum / n_valid, _EPS)
    if k_est >= 0.5 * n_valid:
        stats["path"] = "flat-fallback"
        rows, ts, tc, n_kept = _flat_pool_greedy(pool, budget, thresholds)
        return rows, ts, tc, n_kept
    F = int(min(max_count, max(32, 1 << int(np.ceil(
        np.log2(4.0 * k_est / S + 8.0))))))
    ratio = mirror.masked_ratio(valid)
    while True:
        stats["frontier"] = F
        vals, rows = mirror.frontier(ratio, F)
        cand = rows[np.isfinite(vals)]
        stats["candidates"] = int(cand.size)
        # Host-precision merge: exact greedy over the candidate set.
        # overall_score on the gathered rows only — identical per-row
        # values to pool.overall, without forcing the pool-wide O(n)
        # cache rebuild after every churn event.
        sc = overall_score(pool.scores[cand])
        cs = pool.costs[cand]
        ratio_c = sc / np.maximum(cs, _EPS)
        pos = np.lexsort((cand, -ratio_c))    # ratio desc, row asc on ties
        cand_s, oc = cand[pos], cs[pos]
        rem = np.subtract.accumulate(
            np.concatenate(([budget], oc)))[:-1]
        unaff = oc > rem
        stopped = bool(unaff.any())
        k = int(np.argmax(unaff)) if stopped else oc.size
        # Escalate iff a clipped shard could still change the answer:
        # its whole frontier fed the consumed prefix (selection + the
        # stopping client), or the scan never stopped at all.
        clipped = counts > F
        if clipped.any() and F < max_count:
            prefix = cand_s[: k + 1] if stopped else cand_s
            contrib = np.bincount(prefix // mirror.shard_cap, minlength=S)
            suspect = clipped & (contrib >= F) if stopped else clipped
            if suspect.any():
                F = min(2 * F, max_count)
                stats["escalations"] += 1
                continue
        chosen = cand_s[:k]
        return (chosen, float(sc[pos][:k].sum()), float(oc[:k].sum()),
                n_valid)


def hierarchical_greedy_knapsack_batch(pool, budgets: np.ndarray,
                                       thresholds_list,
                                       *, mirror=None,
                                       shard_cap: int | None = None):
    """Batched :func:`hierarchical_greedy_knapsack` for multi-tenant
    sweeps: one mirror sync serves every task; each task then runs its
    own frontier + host merge (per-task thresholds make the device mask
    task-specific, so there is no shared argsort to amortize — the
    shared work is the mirror itself).

    ``thresholds_list``: per-task thresholds (or ``None``), length T.
    Returns a list of ``(rows, total_score, total_cost, n_valid)``.
    """
    if mirror is None:
        mirror = pool.device_mirror(shard_cap=shard_cap)
    else:
        mirror.sync(pool)
    budgets = np.atleast_1d(np.asarray(budgets, dtype=np.float64))
    return [hierarchical_greedy_knapsack(pool, float(b), th, mirror=mirror)
            for b, th in zip(budgets, thresholds_list)]


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


def _pinned(key: str, nbytes: int) -> torch.Tensor:
    """A page-locked host buffer of at least ``nbytes``, kept for the next
    solve: each solve waits for its result, which the stream copies after
    its input, so a buffer is free again when the solve returns."""
    buf = _PINNED.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8,
                          pin_memory=True)
        _PINNED[key] = buf
    return buf


_PINNED: dict[str, torch.Tensor] = {}
_PINNED_LOCK = threading.Lock()      # one solve at a time uses the buffers


def solve_mkp_greedy_device(values, weights, capacities,
                            max_size: int | None = None, device=None
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Toyoda greedy on the device (``device``, None -> ``cuda``), in
    f32 as the reference's ``solve_mkp_greedy_jax``: each pick rescores
    every item and takes the first best one, through
    ``kernels.ops.mkp_greedy``. On the card that is one launch a solve:
    v, w and the capacities go over in one copy from a page-locked
    buffer, and the mask and ``used`` come back in one copy. On the CPU
    it is the plain version (``kernels.ref.mkp_greedy_ref``).

    Returns ``(selection_mask (n,), used (m,))``. Matches the greedy
    phase of ``mkp.solve_mkp_greedy`` (``local_search=False``) up to
    float32 utility ties.
    """
    dev = resolve_device(device)
    n, m = np.shape(weights)
    if dev.type == "cpu":
        v, wt, cap = (torch.from_numpy(np.ascontiguousarray(a, np.float32))
                      for a in (values, weights, capacities))
        in_sel, used = ops.mkp_greedy(v, wt, cap, max_size)
        return in_sel.numpy(), used.numpy()
    size = n + n * m + m
    with _PINNED_LOCK:
        host = _pinned("in", 4 * size)[:4 * size].view(torch.float32)
        flat = host.numpy()
        flat[:n] = values
        flat[n:n + n * m].reshape(n, m)[...] = weights
        flat[n + n * m:] = capacities
        buf = host.to(dev, non_blocking=True)
        in_sel, used = ops.mkp_greedy(buf[:n], buf[n:n + n * m].view(n, m),
                                      buf[n + n * m:], max_size)
        out = _pinned("out", 4 * m + n)[:4 * m + n]
        out.copy_(_mkp_kernel.packed(used), non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        out = out.numpy()
        return (out[4 * m:].view(np.bool_).copy(),
                out[:4 * m].view(np.float32).copy())
