"""Bind the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

It replaces the JAX package's Pallas kernel ``kernels/rmsnorm.py::rmsnorm``
with the rounding of its oracle ``ref.rmsnorm_ref`` (see the source for
its bound and design). Built with the port's other kernels at first use
(:mod:`repro_torch.kernels.build`); nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

DTYPES = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float) + (ctypes.c_int,) * 5
ROUTES = {"loop": 0, "regs": 1, "split": 2}
REGISTER_VECTORS = (1, 2, 4, 8)  # R on the register route, and at G = 1
SPLIT_VECTORS = (1, 2, 3, 4)     # R on the split route at G > 1
PREFILL_VECTORS = 4    # most 16-byte vectors a lane past the register route
DECODE_VECTORS = 2     # ... at fewer rows than SMs: more warps, loads out at once
MAX_WARPS = 32         # a block on the split route
H100_SMS = 132


class Plan(NamedTuple):
    """How a call is laid out on the card: ``route`` ("regs", "split" or
    "loop"), ``warps`` a row (G), 16-byte ``vectors`` a lane (R; 0 on the
    loop route) and ``rows`` a block."""
    route: str
    warps: int
    vectors: int
    rows: int


def plan(M: int, D: int, itemsize: int, vec: bool,
         sms: int = H100_SMS) -> Plan:
    """The layout of an (M, D) call of ``itemsize``-byte values; ``vec``
    says 16-byte loads are allowed (D a multiple of 16 / itemsize, every
    pointer on a 16-byte boundary). Prefill is at least as many rows as
    the card has SMs, a decode step fewer.

    - Rows that cannot take 16-byte loads: the loop, element-wise.
    - Rows of up to 32 x 8 vectors (2,048 bf16, 1,024 f32), with R the
      least in :data:`REGISTER_VECTORS` that holds the row: at a decode
      step the register route, one warp a row, eight rows a block; at
      prefill the split route at one warp a row (G = 1, the same sums in
      the same order, so the same bits), eight rows a block.
    - Wider rows: the split route with the fewest warps a row for R <=
      :data:`PREFILL_VECTORS` at prefill and R <= :data:`DECODE_VECTORS`
      at a decode step (R <= 4 where 32 warps need it), one row a block.
      At prefill the kernel's 56 registers a thread let an SM hold 6-7
      such blocks of 5-6 warps (about 36 warps loading), and the grid
      persists over the rows.
    - Rows past 32 x 32 x 4 vectors (32,768 bf16): the loop.
    """
    if not vec:
        return Plan("loop", 1, 0, 8)
    V = -(-D // (16 // itemsize))
    decode = M < sms
    if V <= 32 * REGISTER_VECTORS[-1]:
        R = next(r for r in REGISTER_VECTORS if 32 * r >= V)
        return Plan("regs" if decode else "split", 1, R, 8)
    for most in ((DECODE_VECTORS, PREFILL_VECTORS) if decode
                 else (PREFILL_VECTORS,)):
        G = -(-V // (32 * most))
        if G <= MAX_WARPS:
            return Plan("split", G, -(-V // (32 * G)), 1)
    return Plan("loop", 1, 0, 8)


def _check(p: Plan, D: int, itemsize: int, vec: bool) -> None:
    """Raise ValueError on a forced plan the kernel does not take."""
    V = -(-D // (16 // itemsize))
    ok = {"loop": lambda: True,
          "regs": lambda: vec and p.vectors in REGISTER_VECTORS
          and 32 * p.vectors >= V,
          "split": lambda: vec and p.warps >= 1 and p.rows >= 1
          and p.warps * p.rows <= MAX_WARPS
          and (p.vectors in SPLIT_VECTORS or p.warps == 1 and p.vectors == 8)
          and 32 * p.warps * p.vectors >= V}
    if p.route not in ok or not ok[p.route]():
        raise ValueError(f"rmsnorm kernel does not take {p} at D={D}, "
                         f"itemsize {itemsize}, 16-byte loads {vec}")


@functools.cache
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
            layout: Plan | None = None) -> torch.Tensor:
    """Launch the kernel. x: (..., D) and scale: (D,), CUDA tensors of one
    type, float32 or bfloat16. Returns (..., D) in that type, as
    :func:`repro_torch.kernels.ref.rmsnorm_ref` defines it. ``layout``
    forces another :class:`Plan` than :func:`plan`'s (to time or hold one
    against another). Raises on any input or layout the kernel does not
    take and on a failed launch."""
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
    size = x.element_size()
    vec = D % (16 // size) == 0 and build.aligned16(xm, scale, out)
    if layout is None:
        layout = plan(M, D, size, vec, _num_sms(x.device))
    else:
        _check(layout, D, size, vec)
    build.launch(build.entry(DTYPES[x.dtype], _ARGTYPES), x.device,
                 xm.data_ptr(), scale.data_ptr(), out.data_ptr(), M, D,
                 float(eps), int(vec), ROUTES[layout.route], layout.vectors,
                 layout.warps, layout.rows)
    return out.reshape(x.shape)
