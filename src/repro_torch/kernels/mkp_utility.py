"""Bind the Toyoda pseudo-utility CUDA kernel (``csrc/mkp_utility.cu``).

It replaces the JAX package's Pallas kernel
``kernels/mkp_utility.py::mkp_utility``, the per-pick rescoring of
stage 2's device MKP greedy (see the source for its bound and design).
Built with the port's other kernels at first use
(:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong, ctypes.c_int)


def mkp_utility(values: torch.Tensor, weights: torch.Tensor,
                residual: torch.Tensor, selectable: torch.Tensor):
    """Launch the kernel on CUDA tensors. values (n,), weights (n, m),
    residual (m,): float32, contiguous; selectable (n,) bool; n >= 1.

    Returns (n,) float32 utilities as
    :func:`repro_torch.kernels.ref.mkp_utility_ref` defines them, bit for
    bit. Raises on any input the kernel does not take and on a failed
    launch.
    """
    ins = (values, weights, residual, selectable)
    if any(t.device.type != "cuda" for t in ins):
        raise ValueError("mkp_utility kernel needs CUDA tensors")
    if any(t.device != values.device for t in ins):
        raise ValueError("mkp_utility inputs must share one device")
    if any(t.dtype != torch.float32 for t in ins[:3]) \
            or selectable.dtype != torch.bool:
        raise ValueError("mkp_utility takes float32 values, weights and "
                         "residual and a bool selectable mask")
    if weights.ndim != 2:
        raise ValueError(f"weights must be (n, m), got {tuple(weights.shape)}")
    n, m = weights.shape
    if values.shape != (n,) or selectable.shape != (n,) \
            or residual.shape != (m,):
        raise ValueError("shapes must be values (n,), weights (n, m), "
                         "residual (m,), selectable (n,); got "
                         f"{[tuple(t.shape) for t in ins]}")
    if n < 1:
        raise ValueError("mkp_utility needs n >= 1")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("mkp_utility inputs must be contiguous")
    out = torch.empty(n, dtype=torch.float32, device=values.device)
    build.launch(build.entry("mkp_utility_f32", _ARGTYPES), values.device,
                 values.data_ptr(), weights.data_ptr(), residual.data_ptr(),
                 selectable.data_ptr(), out.data_ptr(), n, m)
    return out
