"""Public wrappers for the port's hand-written kernels.

Each op dispatches on where its tensors lie: a CUDA tensor launches the
kernel (or raises; there is no fallback), a CPU tensor takes the plain
PyTorch version in :mod:`repro_torch.kernels.ref`. ``LAUNCHES`` counts
each op's kernel launches, so a run can show that its main path went
through the kernel; set an entry to 0 to start a count.

- ``fedavg_agg_quality`` replaces the JAX package's Pallas kernel
  ``src/repro/kernels/fedavg_agg.py::fedavg_agg_quality`` (line 91). It
  is bandwidth-bound: it must read U (K, P) once and write agg (P,), so
  its bound is (K + 1)·P·itemsize bytes over the card's memory rate —
  about 18 µs at the main path's K = 13, P = 1,070,794 (f32) on an H100
  SXM's 3.35 TB/s. The device plane launches it once per round.
- ``fedavg_agg`` replaces ``src/repro/kernels/fedavg_agg.py::fedavg_agg``
  (line 40): the aggregate alone, with the same bound.
  ``fedavg_agg_tree`` takes it over every leaf of stacked parameters in
  one launch (a table of up to 32 leaves of one dtype a launch), so the
  host-loop round (``fl.round.make_fl_round(use_agg_kernel=True)``)
  launches it once a round for the CNN.
- ``segmented_topk`` replaces ``src/repro/kernels/segmented_topk.py``
  (line 62): the per-shard frontier of the fleet-scale stage 1, launched
  once per frontier (per task, and again per escalation).
- ``mkp_utility`` and ``mkp_greedy`` replace
  ``src/repro/kernels/mkp_utility.py`` (line 42): the Toyoda update of
  stage 2's MKP greedy, one rescoring as the reference's
  ``ops.mkp_utility`` (no path of the port calls it), and the whole
  greedy of one MKP solve with that rescoring inside, launched once a
  solve by ``engine.solve_mkp_greedy_device``.
- ``topk_sparsify``, ``quantize_i8``, ``dequantize_i8`` and
  ``fedavg_agg_quality_i8`` replace ``src/repro/kernels/compression.py``
  (lines 81, 117, 145, 197): the codecs of the compressed update plane
  (fl.compression), launched once per round by the codec that uses
  them.
- ``rmsnorm``, ``swiglu`` and ``flash_attention`` replace
  ``src/repro/kernels/{rmsnorm,swiglu,flash_attention}.py`` (lines 23,
  38, 77): the serve path's norms, MLPs and prefill attention.
- ``mlstm_scan`` replaces ``src/repro/kernels/mlstm_scan.py`` (line
  95): chunkwise gated linear attention, once per mLSTM layer (xLSTM)
  or mamba head (Hymba) in prefill; it also returns the final state.

``PLAIN`` holds the plain versions of the ops that fl.round and
fl.compression and models.transformer call, under the same names:
passed as their ``kernels`` argument, it runs a path on the card through
the plain versions, to hold it against the kernels.
"""
from __future__ import annotations

import functools
import types

import torch

from . import compression as _compression
from . import fedavg_agg as _fedavg_agg
from . import flash_attention as _flash_attention
from . import mkp_utility as _mkp_utility
from . import mlstm_scan as _mlstm_scan
from . import ref
from . import rmsnorm as _rmsnorm
from . import segmented_topk as _segmented_topk
from . import swiglu as _swiglu

LAUNCHES = {"fedavg_agg": 0, "fedavg_agg_quality": 0, "segmented_topk": 0,
            "mkp_utility": 0, "mkp_greedy": 0, "topk_sparsify": 0,
            "quantize_i8": 0, "dequantize_i8": 0, "fedavg_agg_quality_i8": 0,
            "rmsnorm": 0, "swiglu": 0, "flash_attention": 0, "mlstm_scan": 0}


def fedavg_agg(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Σ_k p_k u_k of updates (K, P) with weights (K,), in updates.dtype,
    summed in f32; see :func:`repro_torch.kernels.ref.fedavg_agg_ref`."""
    if updates.device.type == "cpu":
        return ref.fedavg_agg_ref(updates, weights)
    out = _fedavg_agg.fedavg_agg(updates, weights)
    LAUNCHES["fedavg_agg"] += 1
    return out


def fedavg_agg_tree(stacked: dict[str, torch.Tensor],
                    weights: torch.Tensor) -> dict[str, torch.Tensor]:
    """:func:`fedavg_agg` of every leaf of stacked parameters (leaves
    (K, ...)): on the card one launch over all the leaves (one a table of
    up to 32 leaves of one dtype), each leaf bit-equal to its own
    :func:`fedavg_agg`; on the CPU the plain version per leaf."""
    if weights.device.type == "cpu":
        return _fedavg_agg.fedavg_agg_tree(stacked, weights,
                                           agg=ref.fedavg_agg_ref)
    out, launches = _fedavg_agg.fedavg_agg_leaves(stacked, weights)
    LAUNCHES["fedavg_agg"] += launches
    return out


def fedavg_agg_quality(updates: torch.Tensor, weights: torch.Tensor):
    """Fused Δ_t aggregation + per-client quality pass (one read of the
    stacked updates). Returns ``(agg (P,), dots (K,), sq (K,), asq ())``;
    see :func:`repro_torch.kernels.ref.fedavg_agg_quality_ref`."""
    if updates.device.type == "cpu":
        return ref.fedavg_agg_quality_ref(updates, weights)
    out = _fedavg_agg.fedavg_agg_quality(updates, weights)
    LAUNCHES["fedavg_agg_quality"] += 1
    return out


def segmented_topk(x: torch.Tensor, k: int):
    """Per-row top-k of x (S, C) (``-inf``-padded shards). Returns
    ``(values (S, k) f32, lanes (S, k) int32)``, descending per row, ties
    to the lowest lane; see :func:`repro_torch.kernels.ref.segmented_topk_ref`."""
    if x.device.type == "cpu":
        return ref.segmented_topk_ref(x, k)
    out = _segmented_topk.segmented_topk(x, k)
    LAUNCHES["segmented_topk"] += 1
    return out


def mkp_utility(values: torch.Tensor, weights: torch.Tensor,
                residual: torch.Tensor, selectable: torch.Tensor):
    """Toyoda pseudo-utility of every MKP item at once. Returns (n,) f32,
    ``-inf`` where an item cannot be picked; see
    :func:`repro_torch.kernels.ref.mkp_utility_ref`."""
    if values.device.type == "cpu":
        return ref.mkp_utility_ref(values, weights, residual, selectable)
    out = _mkp_utility.mkp_utility(values, weights, residual, selectable)
    LAUNCHES["mkp_utility"] += 1
    return out


def mkp_greedy(values: torch.Tensor, weights: torch.Tensor,
               capacities: torch.Tensor, max_size: int | None = None):
    """The whole Toyoda greedy of one MKP solve (at most ``max_size``
    picks, None: n). Returns ``(in_sel (n,) bool, used (m,) f32)``; see
    :func:`repro_torch.kernels.ref.mkp_greedy_ref`. On the card one launch
    a solve, and both outputs are views of one buffer
    (:func:`repro_torch.kernels.mkp_utility.packed`)."""
    if values.device.type == "cpu":
        return ref.mkp_greedy_ref(values, weights, capacities, max_size)
    out = _mkp_utility.mkp_greedy(values, weights, capacities, max_size)
    LAUNCHES["mkp_greedy"] += 1
    return out


def topk_sparsify(x: torch.Tensor, k: int):
    """Magnitude top-k of each row of x (K, P) (a bf16 input is cast to
    f32 first). Returns ``(values (K, k) f32, indices (K, k) int32)``,
    descending |x|, ties to the lowest index, signed values; see
    :func:`repro_torch.kernels.ref.topk_sparsify_ref`."""
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return ref.topk_sparsify_ref(x, k)
    out = _compression.topk_sparsify(x.contiguous(), k)
    LAUNCHES["topk_sparsify"] += 1
    return out


def quantize_i8(x: torch.Tensor, chunk: int = 256):
    """Per-chunk symmetric int8 of x (K, P) (cast to f32 first). Returns
    ``(values (K, P) int8, scales (K, ceil(P/chunk)) f32)``; see
    :func:`repro_torch.kernels.ref.quantize_i8_ref`."""
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return ref.quantize_i8_ref(x, int(chunk))
    out = _compression.quantize_i8(x.contiguous(), chunk)
    LAUNCHES["quantize_i8"] += 1
    return out


def dequantize_i8(values: torch.Tensor, scales: torch.Tensor,
                  chunk: int = 256) -> torch.Tensor:
    """Inverse of :func:`quantize_i8`: (K, P) int8 + (K, nc) f32 -> (K, P)
    f32; see :func:`repro_torch.kernels.ref.dequantize_i8_ref`."""
    if values.device.type == "cpu":
        return ref.dequantize_i8_ref(values, scales, int(chunk))
    out = _compression.dequantize_i8(values, scales, chunk)
    LAUNCHES["dequantize_i8"] += 1
    return out


def fedavg_agg_quality_i8(values: torch.Tensor, scales: torch.Tensor,
                          weights: torch.Tensor, chunk: int = 256):
    """:func:`fedavg_agg_quality` straight from int8 payloads (dequantized
    in the kernel's registers). Returns ``(agg (P,) f32, dots (K,),
    sq (K,), asq ())``; see
    :func:`repro_torch.kernels.ref.fedavg_agg_quality_i8_ref`."""
    if values.device.type == "cpu":
        return ref.fedavg_agg_quality_i8_ref(values, scales, weights,
                                             int(chunk))
    out = _compression.fedavg_agg_quality_i8(values, scales, weights, chunk)
    LAUNCHES["fedavg_agg_quality_i8"] += 1
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of x (..., D) with scale (D,); see
    :func:`repro_torch.kernels.ref.rmsnorm_ref`."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    out = _rmsnorm.rmsnorm(x, scale, eps)
    LAUNCHES["rmsnorm"] += 1
    return out


def swiglu(x: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor) -> torch.Tensor:
    """``silu(x @ Wg) * (x @ Wu)``: x (..., D), weights (D, F) -> (..., F);
    see :func:`repro_torch.kernels.ref.swiglu_ref`."""
    if x.device.type == "cpu":
        return ref.swiglu_ref(x, w_gate, w_up)
    out = _swiglu.swiglu(x, w_gate, w_up)
    LAUNCHES["swiglu"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, Sq, hd), k / v (B, G, Sk, hd) -> (B, H, Sq, hd); see
    :func:`repro_torch.kernels.ref.flash_attention_ref`."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    out = _flash_attention.flash_attention(q, k, v, causal=causal,
                                           window=window)
    LAUNCHES["flash_attention"] += 1
    return out


def bshd(attend):
    """An attention op on (B, H, S, hd) as one on the models' (B, S, H, hd)
    layout: the axis swaps are views (the kernel takes strides)."""
    def adapter(q, k, v, *, causal=True, window=0):
        t = lambda x: x.transpose(1, 2)
        return t(attend(t(q), t(k), t(v), causal=causal, window=window))
    return adapter


flash_attention_bshd = bshd(flash_attention)
flash_attention_bshd.__doc__ = (
    "Adapter for models.layers' (B, S, H, hd) layout: "
    ":func:`flash_attention` on views with axes 1 and 2 swapped.")


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_f: torch.Tensor, log_i: torch.Tensor | None = None, *,
               chunk: int = 64, normalize: bool = True, initial_state=None):
    """Chunkwise gated linear attention: q, k (B, H, S, dk), v (B, H, S,
    dv), gates (B, H, S) f32 (``log_i=None``: the SSD form). Returns
    ``(out (B, H, S, dv), final state {S, n, m} f32)``; see
    :func:`repro_torch.kernels.ref.mlstm_scan_state_ref`."""
    if q.device.type == "cpu":
        return ref.mlstm_scan_state_ref(q, k, v, log_f, log_i, chunk=chunk,
                                        normalize=normalize,
                                        initial_state=initial_state)
    out = _mlstm_scan.mlstm_scan(q, k, v, log_f, log_i, chunk=chunk,
                                 normalize=normalize,
                                 initial_state=initial_state)
    LAUNCHES["mlstm_scan"] += 1
    return out


def scan_bshd(scan):
    """A scan op on (B, H, S, d) as one on the models' (B, S, H, d)
    layout, with ``models.ssm.gated_linear_attention``'s signature: the
    axis swaps are views (the kernel takes strides)."""
    def adapter(q, k, v, log_f, log_i=None, *, chunk=64, normalize=True,
                initial_state=None):
        t = lambda x: x.transpose(1, 2)
        out, state = scan(t(q), t(k), t(v), t(log_f),
                          None if log_i is None else t(log_i), chunk=chunk,
                          normalize=normalize, initial_state=initial_state)
        return t(out), state
    return adapter


mlstm_scan_bshd = scan_bshd(mlstm_scan)
mlstm_scan_bshd.__doc__ = (
    "Adapter for models.ssm's (B, S, H, d) layout: :func:`mlstm_scan` on "
    "views with axes 1 and 2 swapped.")


def _gated_linear_attention(*args, **kwargs):
    """The plain scan in the models' (B, S, H, d) layout:
    ``models.ssm.gated_linear_attention`` itself, imported at call time
    as ``ref`` does."""
    from ..models.ssm import gated_linear_attention
    return gated_linear_attention(*args, **kwargs)


PLAIN = types.SimpleNamespace(
    fedavg_agg=ref.fedavg_agg_ref,
    fedavg_agg_tree=functools.partial(_fedavg_agg.fedavg_agg_tree,
                                      agg=ref.fedavg_agg_ref),
    fedavg_agg_quality=ref.fedavg_agg_quality_ref,
    topk_sparsify=ref.topk_sparsify_ref,
    quantize_i8=ref.quantize_i8_ref,
    dequantize_i8=ref.dequantize_i8_ref,
    fedavg_agg_quality_i8=ref.fedavg_agg_quality_i8_ref,
    rmsnorm=ref.rmsnorm_ref,
    swiglu=ref.swiglu_ref,
    flash_attention=ref.flash_attention_ref,
    flash_attention_bshd=bshd(ref.flash_attention_ref),
    mlstm_scan=ref.mlstm_scan_state_ref,
    mlstm_scan_bshd=_gated_linear_attention)

__all__ = ["LAUNCHES", "PLAIN", "bshd", "dequantize_i8", "fedavg_agg",
           "fedavg_agg_quality", "fedavg_agg_tree",
           "fedavg_agg_quality_i8", "flash_attention", "flash_attention_bshd",
           "mkp_greedy", "mkp_utility", "mlstm_scan", "mlstm_scan_bshd",
           "quantize_i8", "rmsnorm", "scan_bshd", "segmented_topk", "swiglu",
           "topk_sparsify"]
