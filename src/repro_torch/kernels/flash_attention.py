"""Bind the flash attention CUDA kernel (``csrc/flash_attention.cu``).

It replaces the JAX package's Pallas kernel
``kernels/flash_attention.py::flash_attention``: causal / sliding-window
GQA attention with an online softmax in f32. bf16 at head sizes 64 and
128 runs the Hopper kernel (``wgmma`` over a ring of TMA loads, warp
specialised); bf16 at 16 and 32 runs on the tensor cores through
``mma.sync``; f32 and other head sizes up to 256 run a CUDA-core kernel
(see the source for the bound and the designs). The kernels take
strides, so (B, S, H, hd) tensors viewed as (B, H, S, hd) are read and
written in place. Built with the port's other kernels at first use
(:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .tma import tma_describable

MAX_HD = 256
# The head sizes each bf16 tensor-core kernel takes; f32, and bf16 at
# any other hd, take the CUDA-core kernel ("simple").
ROUTE_HD = {"wgmma": (64, 128), "mma": (16, 32)}
ROUTES = {"simple": 0, "mma": 1, "wgmma": 2}   # the C entry's route argument
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) * 12
             + (ctypes.c_int,) * 6 + (ctypes.c_float,)
             + (ctypes.c_int,) * 4)


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a call of this type and head size takes: "wgmma" (the
    Hopper kernel), "mma" (``mma.sync``) or "simple" (CUDA cores)."""
    if dtype == torch.bfloat16:
        for name, hds in ROUTE_HD.items():
            if hd in hds:
                return name
    return "simple"


def uses_mma(dtype: torch.dtype, hd: int) -> bool:
    """Whether a call takes either tensor-core kernel: ``mma.sync`` (hd 16
    and 32) or ``wgmma`` (hd 64 and 128)."""
    return route(dtype, hd) != "simple"


def uses_wgmma(dtype: torch.dtype, hd: int) -> bool:
    """Whether a call takes the Hopper kernel (``wgmma`` fed by TMA)."""
    return route(dtype, hd) == "wgmma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Launch the kernel. q: (B, H, Sq, hd), k and v: (B, G, Sk, hd), CUDA
    tensors of one type (float32 or bfloat16), H a multiple of G, hd <=
    256, any strides but a contiguous hd axis (others are copied).
    Returns (B, H, Sq, hd) with q's strides, as
    :func:`repro_torch.kernels.ref.flash_attention_ref` defines it.

    Refuses a causal or windowed call with Sq > Sk: query rows would be
    left with no key, and there the reference's oracle (a uniform
    softmax over the -2**30 scores) and its Pallas kernel (0) disagree.
    Raises on any input the kernel does not take and on a failed launch.
    """
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention takes q (B, H, Sq, hd) and k, v "
                         f"(B, G, Sk, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    G, Sk = k.shape[1], k.shape[2]
    if H % G:
        raise ValueError(f"H={H} not a multiple of G={G}")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"flash_attention takes 1 <= hd <= {MAX_HD}, got {hd}")
    if min(B, H, Sq, Sk) < 1 or max(B, H) > 65535 or max(Sq, Sk) >= 2 ** 31:
        raise ValueError(f"flash_attention takes 1 <= B, H <= 65535 and "
                         f"1 <= Sq, Sk < 2**31, got {(B, H, Sq, Sk)}")
    if (causal or window > 0) and Sq > Sk:
        raise ValueError(f"causal or windowed attention with Sq={Sq} > "
                         f"Sk={Sk} leaves query rows with no key")
    kernel = route(q.dtype, hd)

    def ready(t):
        """hd contiguous; for the tensor-core kernels also 16-byte rows."""
        if kernel == "simple":
            return t if t.stride(3) == 1 else t.contiguous()
        return t if tma_describable(t) else t.contiguous()
    q, k, v = ready(q), ready(k), ready(v)
    out = torch.empty_like(q)
    scale = hd ** -0.5 if scale is None else float(scale)
    build.launch(build.entry("flash_attention_fwd", _ARGTYPES), q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], B, H, G, Sq, Sk, hd, scale,
                 int(bool(causal)), int(window), _DTYPES[q.dtype],
                 ROUTES[kernel])
    return out
