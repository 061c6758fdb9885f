"""Compressed client-update codecs for the device round plane.

The round function (fl.round) ships each client's flattened delta — a
row of the stacked ``(K, P)`` update matrix — to the server. This module
defines what crosses the wire when ``TaskRequest.compression`` is set,
and how the server aggregates directly from those payloads:

==============  ====================================================
spec string     wire format (per client)
==============  ====================================================
``none``        raw row: P values in the delta dtype (no codec; the
                round function's result is bit-identical to the
                uncompressed plane)
``int8``        per-chunk symmetric int8: P int8 values +
                ceil(P/chunk) f32 scales (kernels.ops.quantize_i8)
``topk:F``      magnitude top-k, k = ceil(F·P): k f32 values +
                k int32 indices (kernels.ops.topk_sparsify)
``topk:F+int8`` top-k then int8 over the packed values: k int8 +
                ceil(k/chunk) f32 scales + k int32 indices
==============  ====================================================

Options append ``@chunk=N`` to override the 256-lane quant chunk, e.g.
``"int8@chunk=512"`` or ``"topk:0.05+int8@chunk=128"``.

Aggregation (:func:`aggregate_compressed`) is the server's view: int8
payloads go through the fused ``fedavg_agg_quality_i8`` kernel
(dequantized in registers, no (K, P) f32 matrix); top-k payloads are
densified by scatter and go through ``fedavg_agg_quality`` — exact with
respect to the decoded updates either way, so the paper's per-client
quality cosines q_k are computed on what the server received.

:func:`bytes_per_client` is the accounting column of the round metrics
("bytes" = arrived clients × per-client payload).

The spec grammar and the byte accounting are copies of the JAX
package's ``fl.compression``. Every codec step goes through
``kernels`` (default :mod:`repro_torch.kernels.ops`; pass
``kernels.ops.PLAIN`` to run the plain versions on any device).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops as kops

_KINDS = ("none", "int8", "topk", "topk_int8")


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Parsed ``TaskRequest.compression`` string."""
    kind: str = "none"            # one of _KINDS
    topk_frac: float = 0.0        # fraction of P kept (topk kinds)
    chunk: int = 256              # quantization chunk width (int8 kinds)

    @property
    def active(self) -> bool:
        return self.kind != "none"

    def k_for(self, p: int) -> int:
        """Number of kept entries per row for a P-wide flat delta."""
        return max(1, min(p, int(math.ceil(self.topk_frac * p))))

    def describe(self) -> str:
        if self.kind == "none":
            return "none"
        base = self.kind if self.kind != "topk_int8" else \
            f"topk:{self.topk_frac:g}+int8"
        if self.kind == "topk":
            base = f"topk:{self.topk_frac:g}"
        if "int8" in self.kind and self.chunk != 256:
            base += f"@chunk={self.chunk}"
        return base

    @classmethod
    def parse(cls, spec) -> "CompressionSpec":
        """Accepts None, a CompressionSpec, or a spec string."""
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if not isinstance(spec, str):
            raise TypeError(f"compression spec must be str or "
                            f"CompressionSpec, got {type(spec).__name__}")
        text = spec.strip().lower()
        if text in ("", "none"):
            return cls()
        chunk = 256
        if "@" in text:
            text, _, opt = text.partition("@")
            key, _, val = opt.partition("=")
            if key != "chunk":
                raise ValueError(f"unknown compression option {opt!r}")
            chunk = int(val)
            if chunk <= 0:
                raise ValueError("chunk must be positive")
        if text == "int8":
            return cls(kind="int8", chunk=chunk)
        if text.startswith("topk:"):
            body = text[len("topk:"):]
            quant = body.endswith("+int8")
            if quant:
                body = body[: -len("+int8")]
            frac = float(body)
            if not 0.0 < frac <= 1.0:
                raise ValueError(f"topk fraction must be in (0, 1], "
                                 f"got {frac}")
            return cls(kind="topk_int8" if quant else "topk",
                       topk_frac=frac, chunk=chunk)
        raise ValueError(f"unknown compression spec {spec!r}")


def bytes_per_client(spec: CompressionSpec, p: int,
                     raw_itemsize: int = 4) -> int:
    """Wire bytes one client uploads for a P-entry flat delta."""
    if not spec.active:
        return p * raw_itemsize
    if spec.kind == "int8":
        return p + 4 * _n_chunks(p, spec.chunk)
    k = spec.k_for(p)
    if spec.kind == "topk":
        return 4 * k + 4 * k                       # f32 values + i32 indices
    # topk_int8: int8 values + chunk scales + i32 indices
    return k + 4 * _n_chunks(k, spec.chunk) + 4 * k


def _n_chunks(p: int, chunk: int) -> int:
    return -(-p // chunk)


# ---------------------------------------------------------------------------
# Codec round-trip (what the server decodes from the wire)
# ---------------------------------------------------------------------------

def compress(flat: torch.Tensor, spec: CompressionSpec, *, kernels=kops):
    """flat: (K, P) stacked client deltas -> payload dict.

    Keys by kind — int8: {"values" i8, "scales" f32}; topk:
    {"values" f32, "indices" i32}; topk_int8: {"values" i8,
    "scales" f32, "indices" i32}.
    """
    if not spec.active:
        return {"values": flat}
    if spec.kind == "int8":
        v, s = kernels.quantize_i8(flat, spec.chunk)
        return {"values": v, "scales": s}
    k = spec.k_for(flat.shape[1])
    vals, idx = kernels.topk_sparsify(flat, k)
    if spec.kind == "topk":
        return {"values": vals, "indices": idx}
    qv, qs = kernels.quantize_i8(vals, spec.chunk)
    return {"values": qv, "scales": qs, "indices": idx}


def decompress(payload, spec: CompressionSpec, p: int, *, kernels=kops):
    """Payload dict -> the server's (K, P) f32 view of the deltas."""
    if not spec.active:
        return payload["values"]
    if spec.kind == "int8":
        return kernels.dequantize_i8(payload["values"], payload["scales"],
                                     spec.chunk)
    vals = payload["values"]
    if spec.kind == "topk_int8":
        vals = kernels.dequantize_i8(vals, payload["scales"], spec.chunk)
    return _densify(vals, payload["indices"], p)


def _densify(vals: torch.Tensor, idx: torch.Tensor, p: int) -> torch.Tensor:
    """Scatter (K, k) sparse values back to a dense (K, p) f32 matrix.

    Top-k indices are distinct within a row, so a plain scatter is
    exact."""
    dense = torch.zeros(vals.shape[0], p, dtype=torch.float32,
                        device=vals.device)
    return dense.scatter_(1, idx.to(torch.int64), vals.to(torch.float32))


def roundtrip(flat: torch.Tensor, spec: CompressionSpec, *, kernels=kops):
    """compress → decompress: the lossy (K, P) f32 view in one call."""
    payload = compress(flat, spec, kernels=kernels)
    return decompress(payload, spec, flat.shape[1], kernels=kernels)


# ---------------------------------------------------------------------------
# Server-side aggregation directly from compressed payloads
# ---------------------------------------------------------------------------

def aggregate_compressed(flat: torch.Tensor, weights: torch.Tensor,
                         spec: CompressionSpec, *, kernels=kops):
    """Weighted aggregate + quality Gram terms from compressed payloads.

    flat: (K, P) raw stacked deltas (what clients computed), weights:
    (K,) normalized p_k. The deltas are encoded per ``spec`` and the
    server aggregates what it decodes: int8 payloads stream through the
    fused ``fedavg_agg_quality_i8`` kernel; sparse payloads are
    densified and go through ``fedavg_agg_quality``. Returns
    ``(agg (P,) f32, dots (K,), sq (K,), asq ())``.
    """
    payload = compress(flat, spec, kernels=kernels)
    if spec.kind == "int8":
        return kernels.fedavg_agg_quality_i8(payload["values"],
                                             payload["scales"], weights,
                                             spec.chunk)
    decoded = decompress(payload, spec, flat.shape[1], kernels=kernels)
    return kernels.fedavg_agg_quality(decoded, weights)
