"""Bind the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

It replaces the JAX package's Pallas kernel ``kernels/rmsnorm.py::rmsnorm``
with the rounding of its oracle ``ref.rmsnorm_ref`` (see the source for
its bound and design). Built with the port's other kernels at first use
(:mod:`repro_torch.kernels.build`); nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

DTYPES = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int)
REGISTER_VECTORS = (1, 2, 4, 8)


def vectors_per_lane(D: int, itemsize: int, vec: bool) -> int:
    """How many 16-byte vectors of a row each lane holds in registers:
    the least R in :data:`REGISTER_VECTORS` with 32 * R vectors covering
    the row (up to 2,048 bf16 or 1,024 f32), or 0, the loop kernel, for
    wider rows and for rows that cannot take 16-byte loads (``vec``
    false)."""
    per = 16 // itemsize
    if not vec:
        return 0
    return next((r for r in REGISTER_VECTORS if 32 * r * per >= D), 0)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel. x: (..., D) and scale: (D,), CUDA tensors of one
    type, float32 or bfloat16. Returns (..., D) in that type, as
    :func:`repro_torch.kernels.ref.rmsnorm_ref` defines it. Raises on any
    input the kernel does not take and on a failed launch."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("rmsnorm kernel needs x and scale on one CUDA device")
    if x.dtype not in DTYPES or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm takes float32 or bfloat16 x and a scale "
                         f"of the same type, got {x.dtype} and {scale.dtype}")
    if x.ndim < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm takes x (..., D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    D = x.shape[-1]
    xm = x.reshape(-1, D).contiguous()
    M = xm.shape[0]
    if M < 1 or D < 1 or M >= 2 ** 31:
        raise ValueError(f"rmsnorm takes 1 <= rows < 2**31 and D >= 1, got "
                         f"{(M, D)}")
    scale = scale.contiguous()
    out = torch.empty_like(xm)
    vec = D % (16 // x.element_size()) == 0 and build.aligned16(xm, scale,
                                                                 out)
    build.launch(build.entry(DTYPES[x.dtype], _ARGTYPES), x.device,
                 xm.data_ptr(), scale.data_ptr(), out.data_ptr(), M, D,
                 float(eps), int(vec),
                 vectors_per_lane(D, x.element_size(), vec))
    return out.reshape(x.shape)
