"""Plain PyTorch versions of the port's kernels.

Each function here has the exact semantics of its twin in the JAX
package's ``kernels/ref.py``. The CPU tests hold it against that twin,
the kernel wrappers in :mod:`repro_torch.kernels.ops` take it for
tensors that lie on the CPU, and ``chip_smoke.py`` holds each CUDA
kernel against it on the card.
"""
from __future__ import annotations

import torch


def fedavg_agg_quality_ref(updates: torch.Tensor, weights: torch.Tensor):
    """Fused aggregation + quality.

    updates: (K, P), weights: (K,). Returns ``(agg, dots, sq, asq)`` with
    agg = Σ_k p_k u_k in updates.dtype, dots_k = ⟨u_k, agg⟩ against the
    f32 agg (not the cast one), sq_k = ‖u_k‖², asq = ‖agg‖² — all
    accumulated in f32.
    """
    u = updates.to(torch.float32)
    w = weights.to(torch.float32)
    agg = w @ u
    dots = u @ agg
    sq = (u * u).sum(dim=1)
    asq = torch.dot(agg, agg)
    return agg.to(updates.dtype), dots, sq, asq
