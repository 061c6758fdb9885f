"""Bind the fused SwiGLU CUDA kernel (``csrc/swiglu.cu``).

It replaces the JAX package's Pallas kernel ``kernels/swiglu.py::swiglu``:
``silu(x @ Wg) * (x @ Wu)`` with both products taken from the same x
tiles into f32 accumulators (mma.sync for bf16, FMA for f32; see the
source for its bound and design). Built with the port's other kernels at
first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_F = 65535 * 64        # the grid's second axis holds the F tiles
_ARGTYPES = {torch.bfloat16: ("swiglu_bf16", (ctypes.c_void_p,) * 4
                              + (ctypes.c_int,) * 5),
             torch.float32: ("swiglu_f32", (ctypes.c_void_p,) * 4
                             + (ctypes.c_int,) * 3)}


def swiglu(x: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. x: (..., D), w_gate and w_up: (D, F), CUDA
    tensors of one type, float32 or bfloat16. Returns (..., F) in that
    type, as :func:`repro_torch.kernels.ref.swiglu_ref` defines it (up to
    f32 summation order and SiLU's form, see the source). Raises on any
    input the kernel does not take and on a failed launch."""
    if x.device.type != "cuda" or any(w.device != x.device
                                      for w in (w_gate, w_up)):
        raise ValueError("swiglu kernel needs x and weights on one CUDA "
                         "device")
    if x.dtype not in _ARGTYPES or w_gate.dtype != x.dtype \
            or w_up.dtype != x.dtype:
        raise ValueError(f"swiglu takes float32 or bfloat16 x and weights of "
                         f"the same type, got {x.dtype}, {w_gate.dtype}, "
                         f"{w_up.dtype}")
    if x.ndim < 1 or w_gate.ndim != 2 or w_up.shape != w_gate.shape \
            or w_gate.shape[0] != x.shape[-1]:
        raise ValueError(f"swiglu takes x (..., D) and w_gate, w_up (D, F), "
                         f"got {tuple(x.shape)}, {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}")
    D, F = w_gate.shape
    xm = x.reshape(-1, D).contiguous()
    M = xm.shape[0]
    if min(M, D, F) < 1 or max(M, D) >= 2 ** 31 or F > MAX_F:
        raise ValueError(f"swiglu takes 1 <= M, D < 2**31 and 1 <= F <= "
                         f"{MAX_F}, got {(M, D, F)}")
    wg, wu = w_gate.contiguous(), w_up.contiguous()
    out = torch.empty(M, F, dtype=x.dtype, device=x.device)
    name, argtypes = _ARGTYPES[x.dtype]
    args = [xm.data_ptr(), wg.data_ptr(), wu.data_ptr(), out.data_ptr(),
            M, D, F]
    if x.dtype == torch.bfloat16:
        args += [int(D % 8 == 0 and build.aligned16(xm)),
                 int(F % 8 == 0 and build.aligned16(wg, wu))]
    build.launch(build.entry(name, argtypes), x.device, *args)
    return out.reshape(*x.shape[:-1], F)
