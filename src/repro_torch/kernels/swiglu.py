"""Bind the fused SwiGLU CUDA kernels (``csrc/swiglu.cu``).

They replace the JAX package's Pallas kernel ``kernels/swiglu.py::swiglu``:
``silu(x @ Wg) * (x @ Wu)`` with both products taken from the same x
tiles into f32 accumulators. :func:`route` picks one of four kernels by
type, shape and alignment (see the source for their bounds and designs):
``"wgmma"`` (bf16 prefill: a persistent, warp-specialised kernel, TMA
ring and ``wgmma``), ``"splitk"`` (bf16 decode: a split-K weight stream
summed within thread-block clusters), ``"mma"`` (bf16 shapes TMA cannot
describe: ``mma.sync``) and ``"simple"`` (f32: FMA). Built with the
port's other kernels at first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_F = 65535 * 64        # the mma.sync kernel's grid holds the F tiles
# rows the split-K route takes: where it stops winning in
# tools/serve_kernel_bench.py --sweep
DECODE_MAX_M = 8
DECODE_COLS = 64          # F columns of a split-K block
DECODE_CHUNK = 32         # rows of D a TMA box of the split-K kernel
MAX_SPLITS, MAX_KC = 8, 256   # a cluster's splits of D, rows of D a split
_ENTRIES = {
    "wgmma": ("swiglu_wgmma", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3),
    "splitk": ("swiglu_splitk", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5),
    "mma": ("swiglu_bf16", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5),
    "simple": ("swiglu_f32", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3)}


def route(dtype: torch.dtype, M: int, D: int, F: int, aligned: bool) -> str:
    """The kernel a call takes: "simple" for f32; for bf16 "mma" unless
    TMA can describe the operands (D and F multiples of 8 and ``aligned``:
    x and the weights start on 16-byte boundaries), then "splitk" for up
    to ``DECODE_MAX_M`` rows and D up to ``MAX_SPLITS * MAX_KC``, else
    "wgmma"."""
    return _routes(dtype, M, D, F, aligned)[0]


def _routes(dtype, M, D, F, aligned) -> list[str]:
    """Every kernel that takes these operands, :func:`route`'s first."""
    if dtype != torch.bfloat16:
        return ["simple"]
    if not (aligned and D % 8 == 0 and F % 8 == 0):
        return ["mma"]
    if D > MAX_SPLITS * MAX_KC:
        return ["wgmma", "mma"]
    return (["splitk", "wgmma", "mma"] if M <= DECODE_MAX_M
            else ["wgmma", "splitk", "mma"])


def decode_split(D: int, F: int, sms: int) -> tuple[int, int]:
    """(splits, rows a split) of the split-K route: as many splits as keep
    the blocks within two an SM (what the kernel's registers allow at
    eight rows, so they run in one wave), at most ``MAX_SPLITS``, but at
    least enough for splits of at most ``MAX_KC`` rows; rows a multiple
    of ``DECODE_CHUNK`` (the kernel's TMA box)."""
    tiles = -(-F // DECODE_COLS)
    splits = min(MAX_SPLITS, max(1, 2 * sms // tiles, -(-D // MAX_KC)))
    kc = -(-(-(-D // splits)) // DECODE_CHUNK) * DECODE_CHUNK
    return -(-D // kc), kc


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *,
           kernel: str | None = None) -> torch.Tensor:
    """Launch the kernel. x: (..., D), w_gate and w_up: (D, F), CUDA
    tensors of one type, float32 or bfloat16. Returns (..., F) in that
    type, as :func:`repro_torch.kernels.ref.swiglu_ref` defines it (up to
    f32 summation order and SiLU's form, see the source). ``kernel``
    names another kernel that takes these operands than :func:`route`'s
    (to hold each against the others, or time it). Raises on any input
    the kernel does not take and on a failed launch."""
    if x.device.type != "cuda" or any(w.device != x.device
                                      for w in (w_gate, w_up)):
        raise ValueError("swiglu kernel needs x and weights on one CUDA "
                         "device")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or w_gate.dtype != x.dtype or w_up.dtype != x.dtype:
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
    kinds = _routes(x.dtype, M, D, F, build.aligned16(xm, wg, wu))
    kind = kinds[0] if kernel is None else kernel
    if kind not in kinds:
        raise ValueError(f"swiglu kernel {kind!r} does not take these "
                         f"operands; these take them: {kinds}")
    args = [xm.data_ptr(), wg.data_ptr(), wu.data_ptr(), out.data_ptr(),
            M, D, F]
    if kind == "splitk":
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        args += decode_split(D, F, sms)
    elif kind == "mma":
        args += [int(D % 8 == 0 and build.aligned16(xm)),
                 int(F % 8 == 0 and build.aligned16(wg, wu))]
    build.launch(build.entry(*_ENTRIES[kind]), x.device, *args)
    return out.reshape(*x.shape[:-1], F)
