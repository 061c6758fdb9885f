"""Build and bind the FedAvg aggregation CUDA kernels.

Two kernels (CUDA C++ for ``sm_90a``) replace the JAX package's Pallas
kernels of ``kernels/fedavg_agg.py``:

- ``csrc/fedavg_agg_quality.cu`` replaces ``fedavg_agg_quality``: in one
  pass over the stacked client deltas U (K, P) it yields the weighted
  aggregate Δ_t and the Gram terms of every quality cosine
  q_t = cos(Δ_t^(k), Δ_t) (paper §IV-C);
- ``csrc/fedavg_agg.cu`` replaces ``fedavg_agg``: the aggregate Δ_t
  alone, for any K; :func:`fedavg_agg_leaves` takes it over every leaf
  of stacked parameters in one launch (the host-loop round's
  aggregation), with the leaves in a table passed as a kernel parameter.

Both are bandwidth-bound; see the sources for their bounds and designs.
The sources are compiled with the port's other kernels at first use
(:mod:`repro_torch.kernels.build`); nothing is built or loaded at
import, so the CPU tests import this module freely.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

MAX_K = 64               # the kernel's register tiles stop at 64 clients
THREADS = 256            # threads per block, as in the source
MAX_BLOCKS = 1024        # grid cap; the grid depends on P only
_SYMBOLS = {torch.float32: "fedavg_agg_quality_f32",
            torch.bfloat16: "fedavg_agg_quality_bf16"}
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int)
AGG_BLOCKS = 2048        # grid cap of the aggregate kernel (grid-stride)
_AGG_SYMBOLS = {torch.float32: "fedavg_agg_f32",
                torch.bfloat16: "fedavg_agg_bf16"}
_AGG_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_int)
MAX_LEAVES = 32          # leaves a launch of the leaves kernel takes
_LEAVES_SYMBOLS = {torch.float32: "fedavg_agg_leaves_f32",
                   torch.bfloat16: "fedavg_agg_leaves_bf16"}
_LEAVES_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_int)


@functools.cache
def _check_max_k() -> None:
    fn = build.library().fedavg_agg_quality_max_k
    fn.restype = ctypes.c_int
    if fn() != MAX_K:
        raise RuntimeError("kernel and binding disagree on the K maximum")


def num_blocks(P: int) -> int:
    """Grid of the partials kernel: one block per 256 columns, capped."""
    return max(1, min(-(-P // THREADS), MAX_BLOCKS))


def fedavg_agg_quality(updates: torch.Tensor, weights: torch.Tensor):
    """Launch the kernel on CUDA tensors. updates: (K, P) f32/bf16,
    contiguous, 1 <= K <= ``MAX_K``; weights: (K,) (cast to f32).

    Returns ``(agg (P,) updates.dtype, dots (K,), sq (K,), asq ())`` as
    :func:`repro_torch.kernels.ref.fedavg_agg_quality_ref` defines them.
    Raises on any input the kernel does not take and on a failed launch.
    """
    if updates.device.type != "cuda":
        raise ValueError("fedavg_agg_quality kernel needs CUDA tensors")
    if updates.ndim != 2 or updates.dtype not in _SYMBOLS:
        raise ValueError("updates must be (K, P) float32 or bfloat16, got "
                         f"{tuple(updates.shape)} {updates.dtype}")
    K, P = updates.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"fedavg_agg_quality takes 1 <= K <= {MAX_K}, got {K}")
    if P < 1:
        raise ValueError("fedavg_agg_quality needs P >= 1")
    if not updates.is_contiguous():
        raise ValueError("updates must be contiguous")
    if weights.shape != (K,) or weights.device != updates.device:
        raise ValueError("weights must be (K,) on the updates' device")
    w = weights.to(torch.float32).contiguous()
    nb = num_blocks(P)
    dev = updates.device
    agg = torch.empty(P, dtype=updates.dtype, device=dev)
    part = torch.empty(nb * (2 * K + 1), dtype=torch.float32, device=dev)
    out = torch.empty(2 * K + 1, dtype=torch.float32, device=dev)
    _check_max_k()
    build.launch(build.entry(_SYMBOLS[updates.dtype], _ARGTYPES), dev,
                 updates.data_ptr(), w.data_ptr(), agg.data_ptr(),
                 part.data_ptr(), part[nb * K:].data_ptr(),
                 part[2 * nb * K:].data_ptr(), out.data_ptr(), K, P, nb)
    return agg, out[:K], out[K:2 * K], out[2 * K]


def vector_width(updates: torch.Tensor) -> int:
    """Columns a thread of the aggregate kernel loads at once: the
    widest of 16, 8 or 4 bytes (or one element) that divides P and the
    base address, so every row starts on a vector boundary."""
    item = updates.element_size()
    P = updates.shape[1]
    vec = 16 // item
    while vec > 1 and (P % vec or updates.data_ptr() % (vec * item)):
        vec //= 2
    return vec


def fedavg_agg(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Launch the aggregate kernel on CUDA tensors. updates: (K, P)
    f32/bf16, contiguous, any K >= 1; weights: (K,) (cast to f32).

    Returns agg (P,) in updates.dtype, as
    :func:`repro_torch.kernels.ref.fedavg_agg_ref` defines it. Raises on
    any input the kernel does not take and on a failed launch.
    """
    if updates.device.type != "cuda":
        raise ValueError("fedavg_agg kernel needs CUDA tensors")
    if updates.ndim != 2 or updates.dtype not in _AGG_SYMBOLS:
        raise ValueError("updates must be (K, P) float32 or bfloat16, got "
                         f"{tuple(updates.shape)} {updates.dtype}")
    K, P = updates.shape
    if K < 1 or P < 1:
        raise ValueError(f"fedavg_agg needs K >= 1 and P >= 1, got ({K}, {P})")
    if not updates.is_contiguous():
        raise ValueError("updates must be contiguous")
    if weights.shape != (K,) or weights.device != updates.device:
        raise ValueError("weights must be (K,) on the updates' device")
    w = weights.to(torch.float32).contiguous()
    vec = vector_width(updates)
    nb = max(1, min(-(-(P // vec) // THREADS), AGG_BLOCKS))
    agg = torch.empty(P, dtype=updates.dtype, device=updates.device)
    build.launch(build.entry(_AGG_SYMBOLS[updates.dtype], _AGG_ARGTYPES),
                 updates.device, updates.data_ptr(), w.data_ptr(),
                 agg.data_ptr(), K, P, vec, nb)
    return agg


def leaf_tables(leaves: list[tuple[torch.dtype, int, int]]) -> list[dict]:
    """Pack leaves, each ``(dtype, P, vec)`` (vec: :func:`vector_width`),
    into the launch tables of the leaves kernel: the leaves of one dtype
    in their order, at most ``MAX_LEAVES`` a table. Each table has
    ``dtype``, ``leaves`` (indices into ``leaves``), ``chunk0`` (each
    leaf's first chunk of ``THREADS`` column groups, then the total) and
    ``blocks`` (the grid: a block a chunk, capped at ``AGG_BLOCKS``).
    Raises on a dtype the kernel does not take."""
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, (dtype, _, _) in enumerate(leaves):
        if dtype not in _LEAVES_SYMBOLS:
            raise ValueError(f"fedavg_agg takes float32 or bfloat16 leaves, got "
                             f"{dtype}")
        by_dtype.setdefault(dtype, []).append(i)
    tables = []
    for dtype, idx in by_dtype.items():
        for at in range(0, len(idx), MAX_LEAVES):
            chunk0 = [0]
            for i in idx[at:at + MAX_LEAVES]:
                _, P, vec = leaves[i]
                chunk0.append(chunk0[-1] + -(-(P // vec) // THREADS))
            tables.append({"dtype": dtype, "leaves": idx[at:at + MAX_LEAVES],
                           "chunk0": chunk0,
                           "blocks": min(chunk0[-1], AGG_BLOCKS)})
    return tables


@functools.cache
def _check_max_leaves() -> None:
    fn = build.library().fedavg_agg_max_leaves
    fn.restype = ctypes.c_int
    if fn() != MAX_LEAVES:
        raise RuntimeError("kernel and binding disagree on the leaf maximum")


def _flat(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.reshape(leaf.shape[0], -1).contiguous()


def fedavg_agg_leaves(stacked: dict[str, torch.Tensor], weights: torch.Tensor
                      ) -> tuple[dict[str, torch.Tensor], int]:
    """:func:`fedavg_agg` of every leaf of stacked parameters (CUDA
    tensors, f32 or bf16, leading client axis K), one launch per table
    of :func:`leaf_tables`: one for up to ``MAX_LEAVES`` leaves of one
    dtype. Each leaf's output is bit-equal to its own :func:`fedavg_agg`.
    Returns leaves of the per-client shapes and the launches. Raises on
    any input the kernel does not take and on a failed launch."""
    if weights.device.type != "cuda" or any(
            leaf.device != weights.device for leaf in stacked.values()):
        raise ValueError("fedavg_agg kernel needs CUDA tensors on one device")
    K = weights.shape[0] if weights.ndim == 1 else 0
    if K < 1:
        raise ValueError(f"weights must be (K,) with K >= 1, got "
                         f"{tuple(weights.shape)}")
    names = list(stacked)
    flats = [_flat(stacked[n]) for n in names]
    for n, f in zip(names, flats):
        if f.shape[0] != K or f.shape[1] < 1:
            raise ValueError(f"leaf {n!r} must be (K={K}, ...) with at least "
                             f"one element a client, got "
                             f"{tuple(stacked[n].shape)}")
    vecs = [vector_width(f) for f in flats]
    tables = leaf_tables([(f.dtype, f.shape[1], v)
                          for f, v in zip(flats, vecs)])
    w = weights.to(torch.float32).contiguous()
    outs = [torch.empty(f.shape[1], dtype=f.dtype, device=f.device)
            for f in flats]
    _check_max_leaves()
    for t in tables:
        idx = t["leaves"]
        n = len(idx)
        build.launch(
            build.entry(_LEAVES_SYMBOLS[t["dtype"]], _LEAVES_ARGTYPES),
            w.device, (ctypes.c_void_p * n)(*(flats[i].data_ptr() for i in idx)),
            (ctypes.c_void_p * n)(*(outs[i].data_ptr() for i in idx)),
            (ctypes.c_longlong * n)(*(flats[i].shape[1] for i in idx)),
            (ctypes.c_int * n)(*(vecs[i] for i in idx)),
            (ctypes.c_int * (n + 1))(*t["chunk0"]), n, w.data_ptr(), K,
            t["blocks"])
    return ({n: o.reshape(stacked[n].shape[1:]) for n, o in zip(names, outs)},
            len(tables))


def fedavg_agg_tree(stacked: dict[str, torch.Tensor], weights: torch.Tensor,
                    agg=None) -> dict[str, torch.Tensor]:
    """Σ_k w_k · leaf[k] for every leaf of stacked parameters (leading
    client axis K); returns leaves of the per-client shapes. With ``agg``
    None, the kernel over all leaves at once (:func:`fedavg_agg_leaves`);
    else ``agg`` once per leaf on its (K, P_leaf) rows
    (:mod:`repro_torch.kernels.ops` passes the plain version)."""
    if agg is None:
        return fedavg_agg_leaves(stacked, weights)[0]
    return {n: agg(_flat(leaf), weights).reshape(leaf.shape[1:])
            for n, leaf in stacked.items()}
