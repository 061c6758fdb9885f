"""Bind the compressed update plane's CUDA kernels.

They replace the JAX package's Pallas kernels in
``kernels/compression.py``:

- ``topk_sparsify`` (``csrc/segmented_topk.cu``, ``topk_sparsify_f32``):
  the magnitude top-k of each client delta, the segmented top-k's
  launches (a radix select over many blocks a row, a compaction and a
  bitonic sort) keyed on |x|;
- ``quantize_i8`` and ``dequantize_i8`` (``csrc/quantize_i8.cu``):
  per-chunk symmetric int8 and its inverse, bit-equal to their plain
  versions;
- ``fedavg_agg_quality_i8`` (``csrc/fedavg_agg_quality.cu``): the fused
  aggregation + quality pass reading int8 payloads and dequantizing in
  registers.

See the sources for their bounds and designs. Built with the port's
other kernels at first use (:mod:`repro_torch.kernels.build`); nothing
is built or loaded at import.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from . import segmented_topk as _topk
from .fedavg_agg import MAX_K, _check_max_k, num_blocks

_QUANT_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_longlong)
_AGG_I8_ARGTYPES = (ctypes.c_void_p,) * 8 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int)


def _check_2d(name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors")
    if x.ndim != 2 or x.dtype != dtype:
        raise ValueError(f"{name} takes (K, P) {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous input")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name} needs K >= 1 and P >= 1, got "
                         f"{tuple(x.shape)}")


def _check_scales(values: torch.Tensor, scales: torch.Tensor,
                  chunk: int) -> int:
    """The number of chunks a row, after checking chunk and scales."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    K, P = values.shape
    nc = -(-P // chunk)
    if (scales.shape != (K, nc) or scales.dtype != torch.float32
            or scales.device != values.device
            or not scales.is_contiguous()):
        raise ValueError(f"scales must be contiguous ({K}, {nc}) float32 "
                         f"on the values' device, got {tuple(scales.shape)} "
                         f"{scales.dtype}")
    return nc


def topk_sparsify(x: torch.Tensor, k: int):
    """Launch the magnitude top-k. x: (K, P) float32, contiguous, P <=
    ``segmented_topk.MAX_C``; 1 <= k (clipped to P).

    Returns ``(values (K, k) f32, indices (K, k) int32)`` as
    :func:`repro_torch.kernels.ref.topk_sparsify_ref` defines them.
    Raises on any input the kernel does not take and on a failed launch.
    """
    return _topk.launch("topk_sparsify_f32", x, k)


def quantize_i8(x: torch.Tensor, chunk: int = 256):
    """Launch the per-chunk int8 quantizer. x: (K, P) float32, contiguous.

    Returns ``(values (K, P) int8, scales (K, ceil(P/chunk)) f32)``, bit
    for bit as :func:`repro_torch.kernels.ref.quantize_i8_ref` defines
    them. Raises on any input the kernel does not take and on a failed
    launch.
    """
    _check_2d("quantize_i8", x, torch.float32)
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    K, P = x.shape
    nc = -(-P // chunk)
    dev = x.device
    vals = torch.empty(K, P, dtype=torch.int8, device=dev)
    scales = torch.empty(K, nc, dtype=torch.float32, device=dev)
    build.launch(build.entry("quantize_i8_f32", _QUANT_ARGTYPES), dev,
                 x.data_ptr(), vals.data_ptr(), scales.data_ptr(), K, P,
                 chunk, nc)
    return vals, scales


def dequantize_i8(values: torch.Tensor, scales: torch.Tensor,
                  chunk: int = 256) -> torch.Tensor:
    """Launch the inverse: values (K, P) int8 and scales (K, nc) f32, both
    contiguous -> (K, P) f32, bit for bit as
    :func:`repro_torch.kernels.ref.dequantize_i8_ref`."""
    _check_2d("dequantize_i8", values, torch.int8)
    chunk = int(chunk)
    nc = _check_scales(values, scales, chunk)
    K, P = values.shape
    out = torch.empty(K, P, dtype=torch.float32, device=values.device)
    build.launch(build.entry("dequantize_i8_f32", _QUANT_ARGTYPES),
                 values.device, values.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), K, P, chunk, nc)
    return out


def fedavg_agg_quality_i8(values: torch.Tensor, scales: torch.Tensor,
                          weights: torch.Tensor, chunk: int = 256):
    """Launch the fused aggregation + quality pass over int8 payloads.
    values: (K, P) int8, 1 <= K <= ``MAX_K``; scales (K, nc) f32; weights
    (K,) (cast to f32).

    Returns ``(agg (P,) f32, dots (K,), sq (K,), asq ())`` as
    :func:`repro_torch.kernels.ref.fedavg_agg_quality_i8_ref` defines
    them, up to f32 summation order. Raises on any input the kernel does
    not take and on a failed launch.
    """
    _check_2d("fedavg_agg_quality_i8", values, torch.int8)
    chunk = int(chunk)
    nc = _check_scales(values, scales, chunk)
    K, P = values.shape
    if K > MAX_K:
        raise ValueError(f"fedavg_agg_quality_i8 takes 1 <= K <= {MAX_K}, "
                         f"got {K}")
    if weights.shape != (K,) or weights.device != values.device:
        raise ValueError("weights must be (K,) on the values' device")
    w = weights.to(torch.float32).contiguous()
    nb = num_blocks(P)
    dev = values.device
    agg = torch.empty(P, dtype=torch.float32, device=dev)
    part = torch.empty(nb * (2 * K + 1), dtype=torch.float32, device=dev)
    out = torch.empty(2 * K + 1, dtype=torch.float32, device=dev)
    _check_max_k()
    build.launch(build.entry("fedavg_agg_quality_i8", _AGG_I8_ARGTYPES), dev,
                 values.data_ptr(), scales.data_ptr(), w.data_ptr(),
                 agg.data_ptr(), part.data_ptr(), part[nb * K:].data_ptr(),
                 part[2 * nb * K:].data_ptr(), out.data_ptr(), K, P, chunk,
                 nc, nb)
    return agg, out[:K], out[K:2 * K], out[2 * K]
