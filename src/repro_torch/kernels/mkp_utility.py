"""Bind the Toyoda pseudo-utility CUDA kernels (``csrc/mkp_utility.cu``).

They replace the JAX package's Pallas kernel
``kernels/mkp_utility.py::mkp_utility``, the per-pick rescoring of
stage 2's MKP greedy:

- :func:`mkp_utility`: one rescoring of every item;
- :func:`mkp_greedy`: the whole greedy of one MKP solve in one launch
  (the reference runs it as one compiled ``lax.while_loop`` around the
  Pallas kernel), with the same rescoring in its device code.

See the source for their bounds and designs. Built with the port's other
kernels at first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong, ctypes.c_int)
_GREEDY_ARGTYPES = (ctypes.c_void_p,) * 6 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int)
MAX_BLOCKS = 8           # one portable cluster
SMEM_COLS = 2048         # knapsacks whose terms the kernel keeps in shared memory


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


@functools.cache
def _check_limits() -> None:
    lib = build.library()
    for name, want in (("mkp_greedy_max_blocks", MAX_BLOCKS),
                       ("mkp_greedy_smem_cols", SMEM_COLS)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"kernel and binding disagree on {name}")


@functools.lru_cache(maxsize=4096)
def greedy_blocks(n: int, m: int) -> int:
    """The cluster :func:`mkp_greedy` launches: a block per 512 items, at
    least the blocks whose shared memory holds all n rows of m knapsacks
    (the layout lives only in the source), at most ``MAX_BLOCKS`` and n."""
    fn = build.library().mkp_greedy_blocks
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(n, m)


def packed(used: torch.Tensor) -> torch.Tensor:
    """The whole output buffer of :func:`mkp_greedy` as bytes: ``used``
    (m f32) then the mask (n bytes), so one copy brings both back."""
    return torch.empty(0, dtype=torch.uint8, device=used.device).set_(
        used.untyped_storage())


def mkp_greedy(values: torch.Tensor, weights: torch.Tensor,
               capacities: torch.Tensor, max_size: int | None = None):
    """Launch the whole Toyoda greedy of one MKP solve on CUDA tensors.
    values (n,), weights (n, m), capacities (m,): float32, contiguous,
    any alignment; n, m >= 1; at most ``max_size`` picks (None: n). The
    cluster is :func:`greedy_blocks`.

    Returns ``(in_sel (n,) bool, used (m,) f32)``, bit for bit as
    :func:`repro_torch.kernels.ref.mkp_greedy_ref` defines them; both are
    views of one buffer (:func:`packed`). Raises on any input the kernel
    does not take and on a failed launch.
    """
    ins = (values, weights, capacities)
    if any(t.device.type != "cuda" for t in ins):
        raise ValueError("mkp_greedy kernel needs CUDA tensors")
    if any(t.device != values.device for t in ins):
        raise ValueError("mkp_greedy inputs must share one device")
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError("mkp_greedy takes float32 values, weights and "
                         "capacities")
    if weights.ndim != 2:
        raise ValueError(f"weights must be (n, m), got {tuple(weights.shape)}")
    n, m = weights.shape
    if values.shape != (n,) or capacities.shape != (m,):
        raise ValueError("shapes must be values (n,), weights (n, m), "
                         "capacities (m,); got "
                         f"{[tuple(t.shape) for t in ins]}")
    if not 1 <= n < 2 ** 31 or m < 1:
        raise ValueError(f"mkp_greedy needs 1 <= n < 2**31 and m >= 1, got "
                         f"({n}, {m})")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("mkp_greedy inputs must be contiguous")
    picks = n if max_size is None else int(max_size)
    if picks < 0:
        raise ValueError(f"max_size must be >= 0, got {max_size}")
    _check_limits()
    blocks = greedy_blocks(n, m)
    dev = values.device
    out = torch.empty(4 * m + n, dtype=torch.uint8, device=dev)
    used, in_sel = out[:4 * m].view(torch.float32), out[4 * m:].view(torch.bool)
    terms = (torch.empty(blocks * 4 * m, dtype=torch.float32, device=dev)
             if m > SMEM_COLS else None)
    build.launch(build.entry("mkp_greedy_f32", _GREEDY_ARGTYPES), dev,
                 values.data_ptr(), weights.data_ptr(), capacities.data_ptr(),
                 in_sel.data_ptr(), used.data_ptr(),
                 None if terms is None else terms.data_ptr(), n, m, picks,
                 blocks)
    return in_sel, used
