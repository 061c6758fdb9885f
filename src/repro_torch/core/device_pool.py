"""Device-resident selection plane: the sharded torch mirror of
``ClientPoolState`` (fleet-scale stage 1).

``ClientPoolState`` stays the host-side source of truth — churn, id
maps, checkpointing and the dataclass adapters all live there — but at
fleet scale (1M–10M registered clients) the stage-1 hot path cannot
afford to re-stage host buffers onto the device (or re-argsort the full
pool) every sweep. :class:`DevicePoolState` keeps the columns stage 1
actually reads — overall scores, costs, the thresholded criterion
columns, and the registered/alive mask — as ``(num_shards, shard_cap)``
tensors on one device, kept coherent through a **dirty-region sync
protocol**:

- every ``register``/``deregister`` on the host pool appends the
  touched rows to the pool's mutation log
  (``ClientPoolState.dirty_rows_since``);
- :meth:`DevicePoolState.sync` replays only those rows as in-place
  scatters — thousands of churn events per sweep are absorbed in
  O(events) instead of O(pool);
- only when the log no longer reaches back to the mirror's synced
  version (a laggard mirror, or a bulk import) does the mirror fall
  back to a full restage.

Row ``r`` of the host pool lives at shard ``r // shard_cap``, lane
``r % shard_cap``; rows past ``pool.n`` are padding with
``registered=False``, so they can never enter a selection. Growth
appends whole shards.

The mirror feeds the hierarchical two-level greedy
(:func:`repro_torch.core.engine.hierarchical_greedy_knapsack`): per-shard
top-``k`` ratio frontiers via the ``segmented_topk`` kernel (its plain
version for a mirror on the CPU), then an exact host-side merge.
Precision note: the mirror stores f32 — frontier *membership* and
threshold masks are decided in f32, while the final merge re-ranks
candidates with the host's f64 values.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from .criteria import THRESHOLDED, overall_score
from .pool import ClientPoolState

_EPS = 1e-12

# Geometry / routing defaults. ``HIERARCHICAL_MIN_N`` is the pool size
# above which the default greedy selection policy routes stage 1
# through the hierarchical device plane (tests shrink it to force the
# path at toy sizes; REPRO_HIERARCHICAL_MIN_N overrides it at launch).
DEFAULT_SHARD_CAP = 131072
HIERARCHICAL_MIN_N = int(os.environ.get("REPRO_HIERARCHICAL_MIN_N") or 200_000)

_THI = np.asarray(THRESHOLDED, dtype=np.int64)


def same_device(a, b) -> bool:
    """Whether two device specs name one device (``cuda`` without an
    index names the current card)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index == b.index
                                 or a.index is None or b.index is None)


@dataclasses.dataclass
class DevicePoolState:
    """Sharded device mirror of a host :class:`ClientPoolState`.

    All tensors are ``(num_shards, shard_cap)`` (plus a trailing
    criteria/class axis where noted), f32/bool, padding rows
    unregistered, on ``device``. ``histograms`` is optional — stage 1
    never reads it. Unlike the reference's immutable arrays, a sync
    updates these tensors in place.
    """

    shard_cap: int
    n_rows: int                         # host rows mirrored (pool.n)
    device: torch.device
    overall: torch.Tensor | None        # (S, C) f32 — Eq. (6) scores
    costs: torch.Tensor | None          # (S, C) f32
    th_scores: torch.Tensor | None      # (S, C, len(THRESHOLDED)) f32
    registered: torch.Tensor | None     # (S, C) bool — alive mask
    histograms: torch.Tensor | None     # (S, C, c) f32, optional
    synced_version: int                 # host pool.version at last sync
    syncs: int = 0                      # incremental syncs applied
    restages: int = 0                   # full restages (incl. the build)

    @property
    def num_shards(self) -> int:
        return int(self.overall.shape[0])

    @property
    def capacity(self) -> int:
        return self.num_shards * self.shard_cap

    # -- construction / sync -------------------------------------------------
    @classmethod
    def from_host(cls, pool: ClientPoolState, shard_cap: int | None = None,
                  include_histograms: bool = False,
                  device=None) -> "DevicePoolState":
        """Stage ``pool`` onto ``device`` (``None`` -> ``cuda``; raises
        without CUDA)."""
        cap = int(shard_cap or DEFAULT_SHARD_CAP)
        m = cls(shard_cap=cap, n_rows=0, device=resolve_device(device),
                overall=None, costs=None, th_scores=None, registered=None,
                histograms=None, synced_version=-1)
        m._restage(pool, include_histograms=include_histograms)
        return m

    def _restage(self, pool: ClientPoolState,
                 include_histograms: bool | None = None) -> None:
        """Full (re)staging: pad host columns to whole shards and ship
        them. O(pool) — the slow path the dirty-region sync avoids."""
        if include_histograms is None:
            include_histograms = self.histograms is not None
        n, cap = pool.n, self.shard_cap
        S = max(1, -(-n // cap))

        def shard(host, dtype, fill=0.0):
            a = np.asarray(host)
            out = np.full((S * cap,) + a.shape[1:], fill, dtype=dtype)
            out[:n] = a
            return torch.from_numpy(out.reshape((S, cap) + a.shape[1:])
                                    ).to(self.device)

        self.overall = shard(overall_score(pool.scores), np.float32)
        self.costs = shard(pool.costs, np.float32)
        self.th_scores = shard(pool.scores[:, _THI], np.float32)
        self.registered = shard(pool.registered, np.bool_, fill=False)
        self.histograms = shard(pool.histograms, np.float32) \
            if include_histograms else None
        self.n_rows = n
        self.synced_version = pool.version
        self.restages += 1

    def sync(self, pool: ClientPoolState) -> "DevicePoolState":
        """Bring the mirror up to the host pool's version.

        Fast path: replay the dirty rows logged since
        ``synced_version`` as in-place scatters — O(churn events), not
        O(pool). Appends whole shards first if the pool grew past the
        mirrored capacity. Falls back to a full restage when the log
        has been pruned past our watermark.
        """
        if pool.version == self.synced_version:
            return self
        rows = pool.dirty_rows_since(self.synced_version)
        if rows is None:
            self._restage(pool)
            return self
        cap = self.shard_cap
        if pool.n > self.capacity:              # grow by whole shards
            extra = -(-(pool.n - self.capacity) // cap)

            def pad(a, fill):
                blank = torch.full((extra,) + tuple(a.shape[1:]), fill,
                                   dtype=a.dtype, device=a.device)
                return torch.cat([a, blank], dim=0)

            self.overall = pad(self.overall, 0.0)
            self.costs = pad(self.costs, 0.0)
            self.th_scores = pad(self.th_scores, 0.0)
            self.registered = pad(self.registered, False)
            if self.histograms is not None:
                self.histograms = pad(self.histograms, 0.0)
        if rows.size:
            # The reference pads this scatter to a power-of-two width so
            # XLA compiles one scatter per bucket; eager PyTorch compiles
            # nothing, so the port scatters exactly the dirty rows
            # (unique, so no two writes hit one element).
            dev = self.device
            sh = torch.from_numpy(rows // cap).to(dev)
            ln = torch.from_numpy(rows % cap).to(dev)

            def put(col, host, dtype):
                col[sh, ln] = torch.from_numpy(
                    np.ascontiguousarray(host, dtype=dtype)).to(dev)

            scores = pool.scores[rows]          # O(events) host gathers
            put(self.overall, overall_score(scores), np.float32)
            put(self.costs, pool.costs[rows], np.float32)
            put(self.th_scores, scores[:, _THI], np.float32)
            put(self.registered, pool.registered[rows], np.bool_)
            if self.histograms is not None:
                put(self.histograms, pool.histograms[rows], np.float32)
        self.n_rows = pool.n
        self.synced_version = pool.version
        self.syncs += 1
        return self

    # -- stage-1 device queries ----------------------------------------------
    def valid_mask(self, thresholds: np.ndarray | None) -> torch.Tensor:
        """(S, C) bool eligibility under Eq. (8d): registered, and all
        thresholded criteria at/above their minimums (f32 compare)."""
        if thresholds is None:
            return self.registered
        th = torch.from_numpy(np.asarray(
            np.asarray(thresholds, np.float64)[: _THI.size], np.float32)
        ).to(self.device)
        return self.registered & (self.th_scores >= th).all(dim=-1)

    def masked_ratio(self, valid: torch.Tensor) -> torch.Tensor:
        """(S, C) f32 score/cost greedy ratios, ``-inf`` outside
        ``valid`` (the segmented top-k input)."""
        r = self.overall / self.costs.clamp_min(_EPS)
        return torch.where(valid, r, torch.full_like(r, float("-inf")))

    def shard_stats(self, valid: torch.Tensor) -> tuple[np.ndarray, float]:
        """((S,) per-shard valid counts, total valid cost) on host. The
        cost sum only sizes the frontier; it is taken in f64."""
        counts = valid.sum(dim=1, dtype=torch.int64)
        cost_sum = torch.where(valid, self.costs,
                               torch.zeros_like(self.costs)
                               ).sum(dtype=torch.float64)
        return counts.cpu().numpy(), float(cost_sum)

    def frontier(self, ratio: torch.Tensor, k: int
                 ) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard top-``k`` frontier of ``ratio``: host-side
        ``(values (S, k) f32, global row indices (S, k) int64)`` via the
        ``segmented_topk`` kernel (its plain version on the CPU)."""
        vals, lanes = ops.segmented_topk(ratio, int(k))
        rows = (np.arange(self.num_shards, dtype=np.int64)[:, None]
                * self.shard_cap + lanes.cpu().numpy().astype(np.int64))
        return vals.cpu().numpy(), rows
