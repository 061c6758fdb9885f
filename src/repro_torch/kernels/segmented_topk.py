"""Bind the segmented top-k CUDA kernel (``csrc/segmented_topk.cu``).

It replaces the JAX package's Pallas kernel
``kernels/segmented_topk.py::segmented_topk``: the per-shard top-k
frontier of the fleet-scale stage 1 (radix select, then a bitonic sort
of the survivors; see the source for its bound and design). Built with
the port's other kernels at first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_C = 1 << 30          # lanes and the padded sort width stay in int32
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4


def sort_width(k: int) -> int:
    """The survivors' sort width: the least power of two >= k."""
    return 1 << max(0, int(k) - 1).bit_length()


def segmented_topk(x: torch.Tensor, k: int):
    """Launch the kernel on a CUDA tensor. x: (S, C) float32, contiguous,
    C <= ``MAX_C``; 1 <= k (clipped to C).

    Returns ``(values (S, k) f32, lanes (S, k) int32)`` as
    :func:`repro_torch.kernels.ref.segmented_topk_ref` defines them.
    Raises on any input the kernel does not take and on a failed launch.
    """
    if x.device.type != "cuda":
        raise ValueError("segmented_topk kernel needs CUDA tensors")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError("x must be (S, C) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    S, C = x.shape
    if S < 1 or not 1 <= C <= MAX_C:
        raise ValueError(f"segmented_topk takes S >= 1 and 1 <= C <= {MAX_C}, "
                         f"got {(S, C)}")
    k = min(int(k), C)
    if k < 1:
        raise ValueError(f"segmented_topk needs k >= 1, got {k}")
    kp = sort_width(k)
    dev = x.device
    vals = torch.empty(S, k, dtype=torch.float32, device=dev)
    lanes = torch.empty(S, k, dtype=torch.int32, device=dev)
    buf = torch.empty(S, kp, dtype=torch.int64, device=dev)
    scratch = torch.empty(2, S, dtype=torch.int32, device=dev)
    build.launch(build.entry("segmented_topk_f32", _ARGTYPES), dev,
                 x.data_ptr(), vals.data_ptr(), lanes.data_ptr(),
                 buf.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
                 S, C, k, kp)
    return vals, lanes
