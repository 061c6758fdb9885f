"""Build and bind the fused FedAvg aggregation + quality CUDA kernel.

The kernel (``csrc/fedavg_agg_quality.cu``, CUDA C++ for ``sm_90a``)
replaces the JAX package's Pallas kernel
``kernels/fedavg_agg.py::fedavg_agg_quality``: in one pass over the
stacked client deltas U (K, P) it yields the weighted aggregate Δ_t and
the Gram terms of every quality cosine q_t = cos(Δ_t^(k), Δ_t) (paper
§IV-C). It is bandwidth-bound; see the source for its bound and design.

The source is compiled with the port's other kernels at first use
(:mod:`repro_torch.kernels.build`); nothing is built or loaded at
import, so the CPU tests import this module freely.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

MAX_K = 64               # the kernel's register tiles stop at 64 clients
THREADS = 256            # threads per block, as in the source
MAX_BLOCKS = 1024        # grid cap; the grid depends on P only
_SYMBOLS = {torch.float32: "fedavg_agg_quality_f32",
            torch.bfloat16: "fedavg_agg_quality_bf16"}
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int)


@functools.cache
def _check_max_k() -> None:
    fn = build.library().fedavg_agg_quality_max_k
    fn.restype = ctypes.c_int
    if fn() != MAX_K:
        raise RuntimeError("kernel and binding disagree on the K maximum")


def num_blocks(P: int) -> int:
    """Grid of the partials kernel: one block per 256 columns, capped."""
    return max(1, min(-(-P // THREADS), MAX_BLOCKS))


def fedavg_agg_quality(updates: torch.Tensor, weights: torch.Tensor):
    """Launch the kernel on CUDA tensors. updates: (K, P) f32/bf16,
    contiguous, 1 <= K <= ``MAX_K``; weights: (K,) (cast to f32).

    Returns ``(agg (P,) updates.dtype, dots (K,), sq (K,), asq ())`` as
    :func:`repro_torch.kernels.ref.fedavg_agg_quality_ref` defines them.
    Raises on any input the kernel does not take and on a failed launch.
    """
    if updates.device.type != "cuda":
        raise ValueError("fedavg_agg_quality kernel needs CUDA tensors")
    if updates.ndim != 2 or updates.dtype not in _SYMBOLS:
        raise ValueError("updates must be (K, P) float32 or bfloat16, got "
                         f"{tuple(updates.shape)} {updates.dtype}")
    K, P = updates.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"fedavg_agg_quality takes 1 <= K <= {MAX_K}, got {K}")
    if P < 1:
        raise ValueError("fedavg_agg_quality needs P >= 1")
    if not updates.is_contiguous():
        raise ValueError("updates must be contiguous")
    if weights.shape != (K,) or weights.device != updates.device:
        raise ValueError("weights must be (K,) on the updates' device")
    w = weights.to(torch.float32).contiguous()
    nb = num_blocks(P)
    dev = updates.device
    agg = torch.empty(P, dtype=updates.dtype, device=dev)
    part = torch.empty(nb * (2 * K + 1), dtype=torch.float32, device=dev)
    out = torch.empty(2 * K + 1, dtype=torch.float32, device=dev)
    _check_max_k()
    build.launch(build.entry(_SYMBOLS[updates.dtype], _ARGTYPES), dev,
                 updates.data_ptr(), w.data_ptr(), agg.data_ptr(),
                 part.data_ptr(), part[nb * K:].data_ptr(),
                 part[2 * nb * K:].data_ptr(), out.data_ptr(), K, P, nb)
    return agg, out[:K], out[K:2 * K], out[2 * K]
