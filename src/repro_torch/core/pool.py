"""Array-native client pool state (the control plane's internal form).

``ClientPoolState`` is a struct-of-arrays view of a registered client
population: criterion scores ``(n, NUM_CRITERIA)``, label histograms
``(n, c)``, costs ``(n,)``, plus the mutable service-side state
(active mask, participation counts, reputation). It replaces
``list[ClientProfile]`` / ``dict[int, np.ndarray]`` as the internal
representation across selection, scheduling and the service loop, so the
hot paths are masked array ops instead of per-client Python loops.

The pool is *churnable* (paper §III: a shared, changing client
population serving many tasks): :meth:`register` appends clients into
capacity-doubled buffers (amortized O(1), the public arrays are views),
and :meth:`deregister` tombstones rows in place — positions stay stable
for in-flight ``TaskState`` cursors, while the ``registered`` mask
excludes departed clients from selection, ``positions`` lookups, and the
profile views. Every mutation bumps :attr:`version`, which consumers
(``FLServiceProvider.registry``, cached id maps) use for invalidation.

The dataclass API stays: ``from_profiles`` / ``to_profiles`` are the
thin adapters, so anything built on ``ClientProfile`` keeps working.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .criteria import (NUM_CRITERIA, THRESHOLDED, ClientProfile,
                       linear_cost, nid, overall_score)


@dataclasses.dataclass
class ClientPoolState:
    """Struct-of-arrays snapshot of a client pool.

    All arrays share the leading client axis ``n``; row ``i`` describes
    the client with id ``client_ids[i]``. Ids need not be contiguous but
    must be unique.
    """

    client_ids: np.ndarray        # (n,) int64 — external client ids
    scores: np.ndarray            # (n, NUM_CRITERIA) float64 in (0,1)
    histograms: np.ndarray        # (n, c) float64 label histograms
    costs: np.ndarray             # (n,) float64 per-round/task price
    active: np.ndarray = None     # (n,) bool — available for selection
    participation: np.ndarray = None  # (n,) int64 — selections this period
    reputation: np.ndarray = None     # (n,) float64 — running s_rep
    registered: np.ndarray = None     # (n,) bool — False = churned out
    reg_seq: np.ndarray = None        # (n,) int64 — registration event
    # stamp (see reg_counter): lets in-flight tasks spot rows registered
    # (or reactivated by a rejoin) after their own watermark

    _overall: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _pos: dict | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        self.client_ids = np.asarray(self.client_ids, dtype=np.int64)
        self.scores = np.asarray(self.scores, dtype=np.float64)
        self.histograms = np.asarray(self.histograms, dtype=np.float64)
        self.costs = np.asarray(self.costs, dtype=np.float64)
        n = self.client_ids.shape[0]
        if self.scores.shape != (n, NUM_CRITERIA):
            raise ValueError(f"scores must be ({n}, {NUM_CRITERIA}), "
                             f"got {self.scores.shape}")
        if self.histograms.ndim != 2 or self.histograms.shape[0] != n:
            raise ValueError("histograms must be (n, c)")
        if self.costs.shape != (n,):
            raise ValueError("costs must be (n,)")
        if len(np.unique(self.client_ids)) != n:
            raise ValueError("client ids must be unique")
        if self.active is None:
            self.active = np.ones(n, dtype=bool)
        else:
            self.active = np.asarray(self.active, dtype=bool)
        if self.participation is None:
            self.participation = np.zeros(n, dtype=np.int64)
        else:
            self.participation = np.asarray(self.participation, dtype=np.int64)
        if self.reputation is None:
            self.reputation = np.zeros(n, dtype=np.float64)
        else:
            self.reputation = np.asarray(self.reputation, dtype=np.float64)
        if self.registered is None:
            self.registered = np.ones(n, dtype=bool)
        else:
            self.registered = np.asarray(self.registered, dtype=bool)
        if self.reg_seq is None:
            self.reg_seq = np.zeros(n, dtype=np.int64)
        else:
            self.reg_seq = np.asarray(self.reg_seq, dtype=np.int64)
        self.reg_counter = int(self.reg_seq.max()) if n else 0
        self._version = 0
        self._capacity = n            # buffer rows behind the public views
        self._bufs = None             # lazily adopted on first register()
        self._pos_all = None          # id -> row incl. tombstones
        self._sizes = None            # cached data_sizes()
        self._known = None            # id universe (incl. tombstones)
        self._mutlog: list = []       # (version, rows) per churn event —
        # the dirty-region protocol consumed by DevicePoolState.sync
        self._mutlog_floor = 0        # oldest version still replayable
        self._mirror = None           # cached device mirror (lazy)
        self._pins: dict = {}         # client id -> in-flight refcount
        # (PendingChunk schedules pin their members; see pin/unpin)
        self._deferred_dereg: set = set()   # pinned ids whose deregister
        # is deferred until the last unpin
        # runtime timing stats (not serialized, not in _FIELDS): per-row
        # dispatch and collect-timeout tallies fed by the lifecycle's
        # fault-mode dispatch; selection policies read timeout_rate()
        self.timeout_counts = np.zeros(n, dtype=np.int64)
        self.dispatch_counts = np.zeros(n, dtype=np.int64)

    _FIELDS = ("client_ids", "scores", "histograms", "costs", "active",
               "participation", "reputation", "registered", "reg_seq")

    # -- shape ---------------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.client_ids.shape[0])

    @property
    def n_registered(self) -> int:
        return int(self.registered.sum())

    @property
    def version(self) -> int:
        """Monotone mutation counter: bumped by :meth:`register` /
        :meth:`deregister`. Consumers caching derived views (e.g. the
        provider's profile registry) compare against it to invalidate."""
        return self._version

    @property
    def num_classes(self) -> int:
        return int(self.histograms.shape[1])

    def __len__(self) -> int:
        return self.n

    # -- derived quantities (vectorized) -------------------------------------
    @property
    def overall(self) -> np.ndarray:
        """(n,) Eq. (6) overall scores, computed once and cached."""
        if self._overall is None:
            self._overall = overall_score(self.scores)
        return self._overall

    def data_sizes(self) -> np.ndarray:
        """(n,) per-client data sizes, cached until the pool mutates
        (the round loop reads this every chunk dispatch)."""
        if self._sizes is None:
            self._sizes = self.histograms.sum(axis=1)
        return self._sizes

    def nids(self) -> np.ndarray:
        return nid(self.histograms)

    def threshold_mask(self, thresholds: np.ndarray | None) -> np.ndarray:
        """Eq. (8d) per-client boolean mask over the thresholded criteria.

        Pure criteria filter — like the legacy ``threshold_filter`` it
        does NOT consult ``active``; availability is a scheduling-period
        concern (paper §V-B step 4). Intersect with ``self.active``
        explicitly where that semantics is wanted. Clients deregistered
        by churn (``registered == False``) no longer exist to the
        service, so they ARE excluded here.
        """
        if thresholds is None:
            return self.registered.copy()
        th = np.asarray(thresholds, dtype=np.float64)[: len(THRESHOLDED)]
        return np.all(self.scores[:, list(THRESHOLDED)] >= th, axis=1) \
            & self.registered

    def budget_floor(self, n_star: int,
                     mask: np.ndarray | None = None) -> float:
        """Eq. (11): sum of the top-``n_star`` costs among ``mask``."""
        c = self.costs[self.registered] if mask is None else self.costs[mask]
        if c.size == 0 or n_star <= 0:
            return 0.0
        k = min(int(n_star), c.size)
        return float(np.sort(c)[-k:].sum())

    # -- id <-> position -----------------------------------------------------
    def _pos_map(self) -> dict:
        if self._pos is None:
            self._pos = {int(c): i for i, c in enumerate(self.client_ids)
                         if self.registered[i]}
        return self._pos

    def positions(self, ids: Sequence[int] | np.ndarray,
                  include_deregistered: bool = False) -> np.ndarray:
        """Row positions of external ``ids`` (vectorized lookup).

        Raises ``KeyError`` for any id that is not currently registered
        — either never seen, or removed by churn (``deregister``). The
        pre-churn behavior of silently mapping a stale id would let a
        churned-out client index garbage rows downstream.

        ``include_deregistered=True`` also resolves tombstoned rows —
        the mid-period case: a schedule drawn while a client was live
        keeps training against its (still resident) row until the next
        period checkpoint drops it.
        """
        pos = self._pos_map()
        if include_deregistered and len(pos) < self.n:
            if self._pos_all is None:
                self._pos_all = {int(c): i
                                 for i, c in enumerate(self.client_ids)}
            pos = self._pos_all
        try:
            return np.fromiter((pos[int(c)] for c in ids),
                               dtype=np.int64, count=len(ids))
        except KeyError as e:
            raise KeyError(
                f"client id {e.args[0]} is not registered in the pool "
                f"(unknown, or removed by deregister)") from None

    def is_registered(self, ids: Sequence[int] | np.ndarray) -> np.ndarray:
        """(len(ids),) bool: which external ids are currently registered
        (amortized via the cached id->row map)."""
        pos = self._pos_map()
        return np.array([int(c) in pos for c in ids], dtype=bool)

    # -- churn (register / deregister) ---------------------------------------
    _MUTLOG_MAX = 65536               # churn events retained for replay

    def _bump_version(self) -> None:
        self._version += 1

    def _log_mutation(self, rows: np.ndarray) -> None:
        """Record the rows touched by the mutation that produced the
        current ``version`` (the dirty-region log). Device mirrors
        replay entries newer than their synced version instead of
        re-staging whole buffers; once the log overflows, the floor
        rises and laggards fall back to a full restage."""
        self._mutlog.append((self._version, np.asarray(rows, np.int64)))
        if len(self._mutlog) > self._MUTLOG_MAX:
            drop = len(self._mutlog) - self._MUTLOG_MAX
            self._mutlog_floor = self._mutlog[drop - 1][0]
            del self._mutlog[:drop]

    def dirty_rows_since(self, version: int) -> np.ndarray | None:
        """Unique rows mutated after ``version`` (ascending), or
        ``None`` when the log no longer reaches back that far (the
        caller must re-stage from scratch). ``version`` equal to the
        current :attr:`version` returns an empty array."""
        if version < self._mutlog_floor:
            return None
        rows = [r for v, r in self._mutlog if v > version]
        if not rows:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate(rows))

    def device_mirror(self, shard_cap: int | None = None,
                      include_histograms: bool = False, device=None):
        """The pool's cached :class:`~repro_torch.core.device_pool.
        DevicePoolState` (sharded tensors), synced to the current
        version via the dirty-region log — thousands of churn events
        per sweep update row slices in place instead of re-staging the
        buffers. Rebuilt only when the requested geometry or device
        changes. ``device=None`` means the cached mirror's device, else
        ``cuda`` (raising without CUDA)."""
        from .device_pool import DevicePoolState, same_device
        m = self._mirror
        if (m is None
                or (shard_cap is not None and m.shard_cap != shard_cap)
                or (include_histograms and m.histograms is None)
                or (device is not None
                    and not same_device(m.device, device))):
            if device is None and m is not None:
                device = m.device
            m = DevicePoolState.from_host(
                self, shard_cap=shard_cap,
                include_histograms=include_histograms, device=device)
            self._mirror = m
        else:
            m.sync(self)
        return m

    def _ensure_capacity(self, extra: int) -> None:
        """Grow the backing buffers (doubling) so ``extra`` more rows fit;
        the public arrays stay views into them."""
        if self._bufs is None:
            self._bufs = {f: getattr(self, f) for f in self._FIELDS}
            self._capacity = self.n
        need = self.n + extra
        if need <= self._capacity:
            return
        cap = max(need, 2 * self._capacity, 4)
        n = self.n
        for f in self._FIELDS:
            a = getattr(self, f)
            buf = np.zeros((cap,) + a.shape[1:], dtype=a.dtype)
            buf[:n] = a
            self._bufs[f] = buf
        self._capacity = cap

    def register(self, profiles: "ClientProfile | Sequence[ClientProfile]"
                 ) -> np.ndarray:
        """Append newly-joined clients (dataclass adapter over
        :meth:`register_arrays`). Returns the new row positions."""
        if isinstance(profiles, ClientProfile):
            profiles = [profiles]
        add = ClientPoolState.from_profiles(profiles)
        return self.register_arrays(add.client_ids, add.scores,
                                    add.histograms, add.costs, add.active)

    def register_arrays(self, client_ids, scores, histograms, costs,
                        active=None) -> np.ndarray:
        """Masked append of ``k`` clients with amortized capacity doubling.

        The public arrays become views of larger buffers, so steady-state
        registration is O(k); cached views (``positions`` map, overall
        scores, provider registries via :attr:`version`) are invalidated.
        A previously deregistered id may rejoin: its tombstoned row is
        reactivated in place with the new profile (positions stay
        stable). Cached id->row maps are updated incrementally (rows
        never move), so churn events stay O(k); the derived-score caches
        and the ``version`` counter are refreshed. Returns the row
        positions of the registered clients, in input order.
        """
        ids = np.asarray(client_ids, dtype=np.int64).reshape(-1)
        k = ids.size
        if k == 0:
            return np.zeros(0, dtype=np.int64)
        scores = np.asarray(scores, dtype=np.float64).reshape(k, -1)
        if scores.shape[1] != NUM_CRITERIA:
            raise ValueError(f"scores must be ({k}, {NUM_CRITERIA})")
        H = np.asarray(histograms, dtype=np.float64)
        if H.ndim != 2 or H.shape[0] != k:
            raise ValueError("histograms must be (k, c)")
        if self.n == 0 and H.shape[1] != self.num_classes:
            self.histograms = np.zeros((0, H.shape[1]))  # adopt c on empty
            if self._bufs is not None:
                self._bufs["histograms"] = self.histograms
        if H.shape[1] != self.num_classes:
            raise ValueError(f"histograms must have {self.num_classes} "
                             f"classes, got {H.shape[1]}")
        costs = np.asarray(costs, dtype=np.float64).reshape(k)
        act = np.ones(k, dtype=bool) if active is None \
            else np.asarray(active, dtype=bool).reshape(k)
        if self._known is None:      # built once; updated incrementally
            self._known = set(int(c) for c in self.client_ids)
        live = self._pos_map()
        dup = sorted({int(c) for c in ids if int(c) in live})
        if dup or len(set(ids.tolist())) != k:
            vals = ids.tolist()
            batch_dup = {v for v in vals if vals.count(v) > 1}
            raise ValueError(f"client ids already registered or duplicated "
                             f"in batch: {sorted(set(dup) | batch_dup)[:5]}")
        # split rejoining tombstones (row reactivated in place, position
        # stable) from genuinely new ids (appended)
        self.reg_counter += 1
        rejoin = np.array([int(c) in self._known for c in ids])
        out = np.empty(k, dtype=np.int64)
        if rejoin.any():
            if self._pos_all is None:
                self._pos_all = {int(c): i
                                 for i, c in enumerate(self.client_ids)}
            rows = np.array([self._pos_all[int(c)] for c in ids[rejoin]],
                            dtype=np.int64)
            self.scores[rows] = scores[rejoin]
            self.histograms[rows] = H[rejoin]
            self.costs[rows] = costs[rejoin]
            self.active[rows] = act[rejoin]
            self.participation[rows] = 0
            self.reputation[rows] = 0.0
            self.registered[rows] = True
            self.reg_seq[rows] = self.reg_counter
            out[rejoin] = rows
        fresh = ~rejoin
        kf = int(fresh.sum())
        if kf:
            self._known.update(int(c) for c in ids[fresh])
            self._ensure_capacity(kf)
            n0, n1 = self.n, self.n + kf
            b = self._bufs
            b["client_ids"][n0:n1] = ids[fresh]
            b["scores"][n0:n1] = scores[fresh]
            b["histograms"][n0:n1] = H[fresh]
            b["costs"][n0:n1] = costs[fresh]
            b["active"][n0:n1] = act[fresh]
            b["participation"][n0:n1] = 0
            b["reputation"][n0:n1] = 0.0
            b["registered"][n0:n1] = True
            b["reg_seq"][n0:n1] = self.reg_counter
            for f in self._FIELDS:
                setattr(self, f, b[f][:n1])
            out[fresh] = np.arange(n0, n1, dtype=np.int64)
        # incremental cache maintenance: rows never move, so the id->row
        # maps just gain the (re)registered entries; score/size caches
        # are stale (new rows / overwritten profiles) and rebuild lazily
        for c, r in zip(ids, out):
            if self._pos is not None:
                self._pos[int(c)] = int(r)
            if self._pos_all is not None:
                self._pos_all[int(c)] = int(r)
        # timing stats follow the row universe: grow for fresh rows,
        # reset for reactivated ones (a rejoin is a new device); a rejoin
        # also cancels any deregister deferred while the old row was
        # pinned — the client is wanted again
        if self.timeout_counts.shape[0] < self.n:
            grow = self.n - self.timeout_counts.shape[0]
            pad = np.zeros(grow, dtype=np.int64)
            self.timeout_counts = np.concatenate([self.timeout_counts, pad])
            self.dispatch_counts = np.concatenate(
                [self.dispatch_counts, pad.copy()])
        if rejoin.any():
            self.timeout_counts[out[rejoin]] = 0
            self.dispatch_counts[out[rejoin]] = 0
        for c in ids:
            self._deferred_dereg.discard(int(c))
        self._overall = None
        self._sizes = None
        self._bump_version()
        self._log_mutation(out)
        return out

    def deregister(self, ids: Sequence[int] | np.ndarray) -> None:
        """Churn-out: tombstone clients in place. Rows keep their
        positions and data, so a task mid-period keeps training its
        already-drawn schedule (``positions(...,
        include_deregistered=True)``) until the next period checkpoint
        drops the client; the ids disappear from plain ``positions``,
        ``threshold_mask`` and the profile views immediately. Raises
        ``KeyError`` for ids not registered.

        Ids referenced by an in-flight ``PendingChunk`` schedule
        (:meth:`pin`) are **deferred**, not tombstoned: the removal is
        applied automatically when the last pin is released (the chunk
        is collected or evicted), so a dispatched schedule never trains
        against a row that silently churned out underneath it."""
        ids = [int(c) for c in np.asarray(ids, dtype=np.int64).reshape(-1)]
        deferred = [c for c in ids if self._pins.get(c)]
        now = [c for c in ids if not self._pins.get(c)]
        self._deferred_dereg.update(deferred)
        if not now:
            return
        rows = self.positions(now)
        self.registered[rows] = False
        self.active[rows] = False
        if self._pos is not None:       # incremental: rows never move
            for c in now:
                self._pos.pop(int(c), None)
        self._bump_version()
        self._log_mutation(rows)

    # -- in-flight pins + timing stats (robustness plane) --------------------
    def pin(self, ids) -> None:
        """Mark ``ids`` as referenced by an in-flight dispatched chunk.
        Pins are refcounted (overlapping tenants may share clients);
        while pinned, :meth:`deregister` defers instead of tombstoning."""
        for c in ids:
            c = int(c)
            self._pins[c] = self._pins.get(c, 0) + 1

    def unpin(self, ids) -> None:
        """Release one pin per id; at refcount zero, any deregister
        deferred while the client was pinned is applied."""
        release = []
        for c in ids:
            c = int(c)
            left = self._pins.get(c, 0) - 1
            if left > 0:
                self._pins[c] = left
            else:
                self._pins.pop(c, None)
                if c in self._deferred_dereg:
                    self._deferred_dereg.discard(c)
                    release.append(c)
        if release:
            self.deregister(release)

    def is_pinned(self, client_id: int) -> bool:
        return self._pins.get(int(client_id), 0) > 0

    def note_timing(self, dispatched_rows: np.ndarray,
                    timeout_rows: np.ndarray) -> None:
        """Tally one dispatch per row in ``dispatched_rows`` and one
        collect-timeout per row in ``timeout_rows`` (fault-mode
        lifecycle bookkeeping; see :meth:`timeout_rate`)."""
        np.add.at(self.dispatch_counts,
                  np.asarray(dispatched_rows, dtype=np.int64), 1)
        np.add.at(self.timeout_counts,
                  np.asarray(timeout_rows, dtype=np.int64), 1)

    def timeout_rate(self) -> np.ndarray:
        """(n,) float — fraction of each client's dispatches that missed
        the round close (0 for never-dispatched clients). Selection
        policies (``straggler_aware``) use this to discount chronic
        stragglers' scores."""
        return self.timeout_counts / np.maximum(self.dispatch_counts, 1)

    def subset(self, index: np.ndarray) -> "ClientPoolState":
        """A new pool state restricted to ``index`` (bool mask or rows)."""
        idx = np.asarray(index)
        return ClientPoolState(
            client_ids=self.client_ids[idx],
            scores=self.scores[idx],
            histograms=self.histograms[idx],
            costs=self.costs[idx],
            active=self.active[idx],
            participation=self.participation[idx],
            reputation=self.reputation[idx],
            registered=self.registered[idx],
            reg_seq=self.reg_seq[idx],
        )

    # -- adapters (dataclass API compatibility) ------------------------------
    @classmethod
    def from_profiles(cls, profiles: Sequence[ClientProfile]) -> "ClientPoolState":
        profiles = list(profiles)
        if not profiles:
            return cls(np.zeros(0, np.int64), np.zeros((0, NUM_CRITERIA)),
                       np.zeros((0, 1)), np.zeros(0))
        return cls(
            client_ids=np.array([p.client_id for p in profiles], np.int64),
            scores=np.stack([p.scores for p in profiles]),
            histograms=np.stack([p.histogram for p in profiles]),
            costs=np.array([p.cost for p in profiles], np.float64),
            active=np.array([p.available for p in profiles], bool),
        )

    def to_profiles(self) -> list[ClientProfile]:
        """Dataclass view of the *registered* clients (churned-out rows
        are tombstones, not clients — they are skipped)."""
        return [
            ClientProfile(
                client_id=int(self.client_ids[i]),
                scores=self.scores[i].copy(),
                histogram=self.histograms[i].copy(),
                cost=float(self.costs[i]),
                available=bool(self.active[i]),
            )
            for i in range(self.n) if self.registered[i]
        ]

    @classmethod
    def from_histograms(cls, histograms: Mapping[int, np.ndarray]) -> "ClientPoolState":
        """Adapter for the scheduler's legacy ``dict[id, hist]`` input.

        Scores are zero placeholders; rows follow ascending client id (the
        legacy scheduler's canonical order).
        """
        ids = np.array(sorted(histograms.keys()), dtype=np.int64)
        if ids.size == 0:
            return cls(ids, np.zeros((0, NUM_CRITERIA)), np.zeros((0, 1)),
                       np.zeros(0))
        H = np.stack([np.asarray(histograms[int(k)], dtype=np.float64)
                      for k in ids])
        return cls(ids, np.zeros((ids.size, NUM_CRITERIA)), H,
                   np.zeros(ids.size))

    # -- constructors --------------------------------------------------------
    @classmethod
    def random(cls, n_clients: int, n_classes: int, rng: np.random.Generator,
               cost_a: float = 2.0, cost_b: float = 5.0,
               integer_cost: bool = True) -> "ClientPoolState":
        """Vectorized virtual-client pool (paper §VIII-A), the array-native
        counterpart of ``criteria.random_profiles`` — O(n·c) with no Python
        loop, so 100k+ client pools build in milliseconds.

        Draws differ from ``random_profiles`` (which samples per client);
        marginal distributions match: per client a uniform label-count
        k ~ U{1..c}, k distinct labels, counts ~ U{10..199}.
        """
        from .criteria import (CRITERIA, data_dist_score,  # no import cycle
                               random_histograms)
        scores = rng.uniform(0.0, 1.0, size=(n_clients, NUM_CRITERIA))
        hists = random_histograms(n_clients, n_classes, rng)
        sizes = hists.sum(axis=1)
        scores[:, CRITERIA.index("data_size")] = sizes / max(sizes.max(), 1e-12)
        scores[:, CRITERIA.index("data_dist")] = data_dist_score(hists)
        costs = linear_cost(overall_score(scores), cost_a, cost_b,
                            integer=integer_cost)
        return cls(np.arange(n_clients, dtype=np.int64), scores, hists, costs)
