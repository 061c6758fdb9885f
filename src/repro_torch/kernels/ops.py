"""Public wrappers for the port's hand-written kernels.

Each op dispatches on where its tensors lie: a CUDA tensor launches the
kernel (or raises; there is no fallback), a CPU tensor takes the plain
PyTorch version in :mod:`repro_torch.kernels.ref`. ``LAUNCHES`` counts
each op's kernel launches, so a run can show that its main path went
through the kernel; set an entry to 0 to start a count.

``fedavg_agg_quality`` replaces the JAX package's Pallas kernel
``src/repro/kernels/fedavg_agg.py::fedavg_agg_quality`` (line 91). It
is bandwidth-bound: it must read U (K, P) once and write agg (P,), so
its bound is (K + 1)·P·itemsize bytes over the card's memory rate —
about 18 µs at the main path's K = 13, P = 1,070,794 (f32) on an H100
SXM's 3.35 TB/s. The main path launches it once per round.
"""
from __future__ import annotations

import torch

from . import fedavg_agg as _fedavg_agg
from . import ref

LAUNCHES = {"fedavg_agg_quality": 0}


def fedavg_agg_quality(updates: torch.Tensor, weights: torch.Tensor):
    """Fused Δ_t aggregation + per-client quality pass (one read of the
    stacked updates). Returns ``(agg (P,), dots (K,), sq (K,), asq ())``;
    see :func:`repro_torch.kernels.ref.fedavg_agg_quality_ref`."""
    if updates.device.type == "cpu":
        return ref.fedavg_agg_quality_ref(updates, weights)
    out = _fedavg_agg.fedavg_agg_quality(updates, weights)
    LAUNCHES["fedavg_agg_quality"] += 1
    return out


__all__ = ["LAUNCHES", "fedavg_agg_quality"]
