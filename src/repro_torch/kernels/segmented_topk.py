"""Bind the per-row top-k CUDA kernel (``csrc/segmented_topk.cu``).

It replaces the JAX package's Pallas kernel
``kernels/segmented_topk.py::segmented_topk``: the per-shard top-k
frontier of the fleet-scale stage 1 (a radix select over many blocks a
row, a compaction, then a bitonic sort of the survivors in tiles over
many blocks; see the source for its bound and design). The same launches, keyed on |x|, serve the
magnitude top-k codec (:func:`repro_torch.kernels.compression.topk_sparsify`).
Built with the port's other kernels at first use
(:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .fedavg_agg import vector_width

MAX_C = 1 << 30          # lanes and the padded sort width stay in int32
MAX_ROWS = 65535         # rows lie on the grid's second axis
MAX_CHUNKS = 256         # chunks a row: one block scan over them
BLOCKS_PER_SM = 4        # select blocks resident on an SM, the aim
MIN_CHUNK = 4096         # lanes: one step of a block at 16-byte loads
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_longlong,)
             + (ctypes.c_int,) * 7)


def sort_width(k: int) -> int:
    """The survivors' sort width: the least power of two >= k."""
    return 1 << max(0, int(k) - 1).bit_length()


def geometry(S: int, C: int, num_sms: int) -> tuple[int, int]:
    """How the select and compact launches cut each row of (S, C):
    ``(chunk, chunks)``, the lanes of a block (a multiple of 4, so
    every vector width divides it) and the blocks a row. Rows x chunks
    aim at ``BLOCKS_PER_SM`` blocks on each of ``num_sms`` SMs, with no
    chunk under ``MIN_CHUNK`` lanes unless the row is shorter, and at
    most ``MAX_CHUNKS`` a row. The chunks cover the row and the last one
    is not empty."""
    want = -(-BLOCKS_PER_SM * max(1, num_sms) // S)
    want = max(1, min(want, MAX_CHUNKS, C // MIN_CHUNK))
    per_block = -(-C // want)
    chunk = -(-per_block // 4) * 4
    return chunk, -(-C // chunk)


def scratch_words(S: int, chunks: int) -> int:
    """The int32 scratch of one call, as the source lays it out: per row
    its pass histograms, counters and choices, per chunk its last-pass
    bins and equals. Asks the built library."""
    fn = build.library().topk_scratch_words
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(S, chunks)


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(symbol: str, x: torch.Tensor, k: int):
    """Run the top-k entry ``symbol`` (``segmented_topk_f32`` or
    ``topk_sparsify_f32``) on x (S, C) float32, contiguous, on the card;
    k is clipped to C. Returns ``(values (S, k) f32, lanes (S, k)
    int32)``. Raises on any input the kernel does not take and on a
    failed launch."""
    if x.device.type != "cuda":
        raise ValueError("the top-k kernel needs CUDA tensors")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError("x must be (S, C) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    S, C = x.shape
    if not 1 <= S <= MAX_ROWS or not 1 <= C <= MAX_C:
        raise ValueError(f"the top-k takes 1 <= S <= {MAX_ROWS} and "
                         f"1 <= C <= {MAX_C}, got {(S, C)}")
    k = min(int(k), C)
    if k < 1:
        raise ValueError(f"the top-k needs k >= 1, got {k}")
    kp = sort_width(k)
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    chunk, chunks = geometry(S, C, _num_sms(index))
    words = scratch_words(S, chunks)
    vals = torch.empty(S, k, dtype=torch.float32, device=dev)
    lanes = torch.empty(S, k, dtype=torch.int32, device=dev)
    buf = torch.empty(S, kp, dtype=torch.int64, device=dev)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    build.launch(build.entry(symbol, _ARGTYPES), dev, x.data_ptr(),
                 vals.data_ptr(), lanes.data_ptr(), buf.data_ptr(),
                 scratch.data_ptr(), words, S, C, k, kp, chunk, chunks,
                 vector_width(x))
    return vals, lanes


def segmented_topk(x: torch.Tensor, k: int):
    """Launch the kernel on a CUDA tensor. x: (S, C) float32, contiguous,
    C <= ``MAX_C``; 1 <= k (clipped to C).

    Returns ``(values (S, k) f32, lanes (S, k) int32)`` as
    :func:`repro_torch.kernels.ref.segmented_topk_ref` defines them.
    Raises on any input the kernel does not take and on a failed launch.
    """
    return launch("segmented_topk_f32", x, k)
