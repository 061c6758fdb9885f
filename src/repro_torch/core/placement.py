"""Tenant -> device placement policies (the multi-device service seam).

With a single global in-flight window, every tenant's round chunks
would funnel through one device stream and the devices beyond the
first would sit idle under "heavy traffic from millions of users"
(arXiv 2312.14941 §III). This module is the placement half of the
fix: small, host-only policies
that map tenant ids onto device indices, mirroring the
``core.policy`` registry so deployments can swap strategies by name
(``ServiceScheduler(..., n_devices=8, placement="bin_pack")``).

The scheduler side (``core.lifecycle``) keeps one ready queue and one
in-flight window *per device* and pumps them independently, so one
device's straggler never stalls another device's tenants; at
``PERIOD_CHECKPOINT`` boundaries it may migrate tenants between
devices when the estimated load imbalance exceeds a threshold
(flush -> re-place -> resume over the ``TaskState.to_arrays``
checkpoint path). See ``docs/placement.md``.

Everything here is numpy-only and device-agnostic: a "device" is just
an index ``0..n_devices-1``. Trainers opt into physical placement by
exposing a ``place_on(device_index)`` hook (looked up with ``getattr``,
like the policy hooks) and resolving ``torch.device("cuda", i)``
themselves — the control plane never imports torch.

Protocol
--------

- :class:`PlacementPolicy` — ``place(tids, n_devices, costs, loads,
  counts)`` maps a batch of tenant ids to ``{tid: device_index}``.
  ``costs`` is the per-tenant estimated per-round cost (seconds; from
  the ``obs/latency`` telemetry window when available, 1.0 otherwise),
  ``loads`` the current estimated cost-weighted load per device and
  ``counts`` the current tenant count per device — all advisory;
  implementations must be deterministic in their inputs so a restored
  service re-places identically.

Shipped policies
----------------

- ``round_robin`` — cyclic assignment in submission order, continuing
  the cycle across incremental batches (the classic baseline).
- ``bin_pack`` — greedy longest-processing-time bin packing: place the
  costliest tenant first, always onto the least-loaded device. With
  per-tenant costs from ``obs/latency`` this approximates makespan-
  balanced placement (2-approximation, Graham 1969).
"""
from __future__ import annotations

from typing import Mapping, Protocol, Sequence, runtime_checkable

import numpy as np

#: obs/latency window entries below this count fall back to the unit
#: cost — one or two samples are noise, not a signal worth packing on.
_MIN_LATENCY_SAMPLES = 1


# ---------------------------------------------------------------------------
# Protocol + registry (mirrors core.policy)
# ---------------------------------------------------------------------------

@runtime_checkable
class PlacementPolicy(Protocol):
    """Maps tenant ids to device indices.

    ``place`` receives the tenants to (re)place in submission order,
    the device count, per-tenant cost estimates, the current
    per-device cost-weighted load vector and the current per-device
    tenant counts (both length ``n_devices``, float64; contributions
    of tenants being re-placed are already subtracted). It returns a
    ``{tid: device_index}`` dict covering exactly ``tids``; indices
    must lie in ``[0, n_devices)``. Implementations are stateless —
    one shared instance serves every scheduler — and deterministic in
    their inputs.
    """

    name: str

    def place(self, tids: Sequence[int], n_devices: int,
              costs: Mapping[int, float], loads: np.ndarray,
              counts: np.ndarray) -> dict[int, int]: ...


_PLACEMENT: dict[str, PlacementPolicy] = {}

DEFAULT_PLACEMENT_POLICY = "bin_pack"


def register_placement_policy(policy):
    """Register a :class:`PlacementPolicy` class or instance under its
    ``name``. Usable as a class decorator; duplicate names raise."""
    inst = policy() if isinstance(policy, type) else policy
    if not isinstance(inst, PlacementPolicy):
        raise TypeError(f"{policy!r} does not implement PlacementPolicy "
                        f"(name, place)")
    if inst.name in _PLACEMENT:
        raise ValueError(f"placement policy {inst.name!r} already registered")
    _PLACEMENT[inst.name] = inst
    return policy


def placement_policy(name: str) -> PlacementPolicy:
    try:
        return _PLACEMENT[name]
    except KeyError:
        raise KeyError(f"unknown placement policy {name!r}; registered: "
                       f"{available_placement_policies()}") from None


def available_placement_policies() -> list[str]:
    return sorted(_PLACEMENT)


def resolve_placement_policy(spec: "str | PlacementPolicy | None"
                             ) -> PlacementPolicy:
    """Registry lookup for a name, passthrough for an instance,
    ``bin_pack`` for ``None`` (the scheduler default)."""
    if spec is None:
        return placement_policy(DEFAULT_PLACEMENT_POLICY)
    if isinstance(spec, str):
        return placement_policy(spec)
    if isinstance(spec, PlacementPolicy):
        return spec
    raise TypeError(f"placement must be a registered name or a "
                    f"PlacementPolicy, got {spec!r}")


# ---------------------------------------------------------------------------
# Cost estimation (the obs/latency bridge)
# ---------------------------------------------------------------------------

def estimate_cost(policy_state: Mapping[str, np.ndarray] | None,
                  default: float = 1.0) -> float:
    """Per-round cost estimate for one tenant, in seconds.

    Reads the rolling ``obs/latency`` window the lifecycle maintains on
    ``TaskState.policy_state`` (mean observed round latency over the
    last <=128 settled rounds). Tenants without telemetry yet — fresh
    submissions, or services running without fault-mode timing — cost
    ``default`` (1.0), which degrades bin packing to count balancing.
    """
    if policy_state is None:
        return float(default)
    lat = policy_state.get("obs/latency")
    if lat is None:
        return float(default)
    lat = np.asarray(lat, dtype=np.float64).ravel()
    lat = lat[np.isfinite(lat) & (lat > 0.0)]
    if lat.size < _MIN_LATENCY_SAMPLES:
        return float(default)
    return float(lat.mean())


def estimate_costs(states: Mapping[int, object],
                   default: float = 1.0) -> dict[int, float]:
    """``{tid: cost}`` over ``{tid: TaskState}`` via :func:`estimate_cost`."""
    return {tid: estimate_cost(getattr(s, "policy_state", None), default)
            for tid, s in states.items()}


def device_loads(placement: Mapping[int, int], costs: Mapping[int, float],
                 n_devices: int) -> np.ndarray:
    """Estimated load per device: sum of placed tenants' costs,
    ``(n_devices,)`` float64."""
    loads = np.zeros(int(n_devices), dtype=np.float64)
    for tid, dev in placement.items():
        loads[dev] += float(costs.get(tid, 1.0))
    return loads


def device_counts(placement: Mapping[int, int], n_devices: int) -> np.ndarray:
    """Tenant count per device, ``(n_devices,)`` float64."""
    counts = np.zeros(int(n_devices), dtype=np.float64)
    for dev in placement.values():
        counts[dev] += 1.0
    return counts


def imbalance(loads: np.ndarray) -> float:
    """Max/mean device-load ratio (>= 1.0; 1.0 = perfectly balanced).

    An empty or all-zero load vector is balanced by definition. This is
    the migrate-on-imbalance trigger: the scheduler re-places when
    ``imbalance(loads) > rebalance_threshold``.
    """
    loads = np.asarray(loads, dtype=np.float64)
    if loads.size == 0:
        return 1.0
    mean = float(loads.mean())
    if mean <= 0.0:
        return 1.0
    return float(loads.max()) / mean


# ---------------------------------------------------------------------------
# Shipped policies
# ---------------------------------------------------------------------------

@register_placement_policy
class RoundRobinPlacement:
    """Cyclic assignment in submission order — the classic baseline.

    Cost-blind: each tenant goes to the device hosting the fewest
    tenants (ties -> lowest index), which on a fresh fleet is exactly
    the 0,1,...,n-1,0,1,... deal and keeps dealing cyclically across
    incremental batches (``counts`` carries the cycle position).
    """

    name = "round_robin"

    def place(self, tids, n_devices, costs, loads, counts):
        cnt = np.asarray(counts, dtype=np.float64).copy()
        out: dict[int, int] = {}
        for tid in tids:
            dev = int(np.argmin(cnt))     # first minimum -> lowest index
            out[int(tid)] = dev
            cnt[dev] += 1.0
        return out


@register_placement_policy
class BinPackPlacement:
    """Greedy LPT bin packing: costliest tenant first, least-loaded
    device always. Ties in cost break by tenant id (submission order),
    ties in load by device index — fully deterministic."""

    name = "bin_pack"

    def place(self, tids, n_devices, costs, loads, counts):
        load = np.asarray(loads, dtype=np.float64).copy()
        order = sorted(tids, key=lambda t: (-float(costs.get(t, 1.0)), t))
        out: dict[int, int] = {}
        for tid in order:
            dev = int(np.argmin(load))
            out[int(tid)] = dev
            load[dev] += float(costs.get(tid, 1.0))
        return out
