"""Plain PyTorch versions of the port's kernels.

Each function here has the exact semantics of its twin in the JAX
package's ``kernels/ref.py``. The CPU tests hold it against that twin,
the kernel wrappers in :mod:`repro_torch.kernels.ops` take it for
tensors that lie on the CPU, and ``chip_smoke.py`` holds each CUDA
kernel against it on the card.
"""
from __future__ import annotations

import torch


def fedavg_agg_ref(updates: torch.Tensor, weights: torch.Tensor):
    """The paper's aggregation Δ_t = Σ_k p_k Δ_t^(k): updates (K, P),
    weights (K,) -> (P,) in updates.dtype, both cast to f32 and
    accumulated in f32."""
    agg = weights.to(torch.float32) @ updates.to(torch.float32)
    return agg.to(updates.dtype)


def fedavg_agg_quality_ref(updates: torch.Tensor, weights: torch.Tensor):
    """Fused aggregation + quality.

    updates: (K, P), weights: (K,). Returns ``(agg, dots, sq, asq)`` with
    agg = Σ_k p_k u_k in updates.dtype, dots_k = ⟨u_k, agg⟩ against the
    f32 agg (not the cast one), sq_k = ‖u_k‖², asq = ‖agg‖² — all
    accumulated in f32.
    """
    u = updates.to(torch.float32)
    w = weights.to(torch.float32)
    agg = w @ u
    dots = u @ agg
    sq = (u * u).sum(dim=1)
    asq = torch.dot(agg, agg)
    return agg.to(updates.dtype), dots, sq, asq


def segmented_topk_ref(x: torch.Tensor, k: int):
    """Segmented top-k: x (S, C) -> ``(values (S, k) f32, lanes (S, k)
    int32)``, descending per row, ties to the lowest lane (``k`` is
    clipped to C). ``torch.topk`` does not promise that tie rule; a
    stable descending sort does. ``-inf`` values mark rows that ran out
    of finite entries."""
    k = int(min(k, x.shape[-1]))
    xf = x.to(torch.float32)
    # + 0.0 turns -0.0 into +0.0, so the two tie on every sort backend
    lanes = torch.sort(xf + 0.0, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    return torch.gather(xf, -1, lanes), lanes.to(torch.int32)


def topk_sparsify_ref(x: torch.Tensor, k: int):
    """Magnitude top-k: x (K, P) -> ``(values (K, k) f32, indices (K, k)
    int32)``, ordered by descending |x|, ties to the lowest index (a
    stable descending sort of |x|, which is ``lax.top_k(|x|, k)``'s
    selection); the values are the signed originals. ``k`` is clipped to
    P. ``abs`` maps -0.0 to +0.0, so the two tie."""
    k = int(min(k, x.shape[-1]))
    xf = x.to(torch.float32)
    idx = torch.sort(xf.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.gather(xf, -1, idx), idx.to(torch.int32)


# 1/127 rounded once to f32: the JAX package's jitted oracle and Pallas
# kernel both scale by it (XLA turns the constant division amax / 127
# into amax * fl(1/127)); the eager oracle divides and may land 1 ulp away.
INV_127 = 1.0 / 127.0


def _chunked(x: torch.Tensor, chunk: int):
    """(K, P) -> (K, nc, chunk) with a zero-padded ragged tail."""
    K, P = x.shape
    nc = -(-P // chunk)
    return torch.nn.functional.pad(x, (0, nc * chunk - P)).reshape(
        K, nc, chunk), nc


def quantize_i8_ref(x: torch.Tensor, chunk: int = 256):
    """Per-chunk symmetric int8: x (K, P) -> ``(values (K, P) int8,
    scales (K, ceil(P/chunk)) f32)`` with scale = amax(|chunk|) · fl(1/127)
    (0 for an all-zero chunk) and values = round_half_even(x / scale), a
    true division, clipped to ±127 (0 where the scale is 0). The ragged
    tail is zero-padded.

    Non-finite input as in the JAX package: the max keeps NaN, so a chunk
    holding a NaN gets scale NaN and values 0; a chunk holding ±inf gets
    scale inf, and its ±inf values (inf / inf = NaN) become 0, the value
    of XLA's NaN-to-int8 cast. That 0 is spelled out here, because
    torch's own cast of NaN to int8 is not defined."""
    K, P = x.shape
    xc, _ = _chunked(x.to(torch.float32), chunk)
    # a Python scalar is rounded to the tensor's f32 before the multiply
    scales = xc.abs().amax(dim=2) * INV_127                    # (K, nc)
    pos = (scales > 0.0)[:, :, None]
    safe = torch.where(pos, scales[:, :, None], torch.ones_like(xc[:, :, :1]))
    q = torch.where(pos, torch.round(xc / safe), torch.zeros_like(xc))
    vals = q.clamp(-127.0, 127.0).nan_to_num(nan=0.0).to(torch.int8)
    return vals.reshape(K, -1)[:, :P], scales


def dequantize_i8_ref(values: torch.Tensor, scales: torch.Tensor,
                      chunk: int = 256):
    """Inverse: (K, P) int8 + (K, nc) f32 scales -> (K, P) f32, each
    value times its chunk's scale (one rounding)."""
    K, P = values.shape
    vc, _ = _chunked(values.to(torch.float32), chunk)
    return (vc * scales[:, :, None]).reshape(K, -1)[:, :P]


def fedavg_agg_quality_i8_ref(values: torch.Tensor, scales: torch.Tensor,
                              weights: torch.Tensor, chunk: int = 256):
    """Compressed fused aggregation: dequantize, then
    :func:`fedavg_agg_quality_ref` (f32 throughout); agg is f32."""
    return fedavg_agg_quality_ref(dequantize_i8_ref(values, scales, chunk),
                                  weights)


def mkp_utility_ref(values: torch.Tensor, weights: torch.Tensor,
                    residual: torch.Tensor, selectable: torch.Tensor,
                    eps: float = 1e-12):
    """Toyoda pseudo-utility: values (n,), weights (n, m), residual (m,),
    selectable (n,) -> (n,) f32, ``v / max(Σ_k w_k / max(r_k, eps), eps)``
    or ``-inf`` where the item is not selectable or does not fit
    (``w > r + eps`` in some column). All in f32; the penalty is summed
    column by column, left to right (not ``w @ s``), so the CUDA kernel,
    which sums in the same order, matches it bit for bit."""
    v = values.to(torch.float32)
    w = weights.to(torch.float32)
    r = residual.to(torch.float32)
    scarcity = torch.ones_like(r) / r.clamp_min(eps)
    penalty = torch.zeros_like(v)
    for k in range(w.shape[1]):
        penalty = penalty + w[:, k] * scarcity[k]
    fits = (w <= r + eps).all(dim=1) & (selectable.to(torch.float32) > 0)
    util = v / penalty.clamp_min(eps)
    return torch.where(fits, util, torch.full_like(util, float("-inf")))


def mkp_greedy_ref(values: torch.Tensor, weights: torch.Tensor,
                   capacities: torch.Tensor, max_size: int | None = None):
    """Toyoda greedy of one MKP solve, in f32 as the reference's
    ``_mkp_greedy_jax``: each of ``max_size`` (None: n) iterations rescores
    every item through :func:`mkp_utility_ref` against
    ``capacities - used``, takes the first maximum (``torch.argmax``: a NaN
    counts as the maximum) and, if its utility is finite, marks the item
    and adds its weights to ``used``. The reference's loop stops at the
    first iteration that is not finite; such an iteration changes nothing,
    and so does every one after it, so this loop runs all of them with no
    host sync inside. Returns ``(in_sel (n,) bool, used (m,) f32)``."""
    v = values.to(torch.float32)
    w = weights.to(torch.float32)
    cap = capacities.to(torch.float32)
    n, m = w.shape
    used = torch.zeros(m, dtype=torch.float32, device=w.device)
    in_sel = torch.zeros(n, dtype=torch.bool, device=w.device)
    zero = torch.zeros(m, dtype=torch.float32, device=w.device)
    for _ in range(n if max_size is None else int(max_size)):
        util = mkp_utility_ref(v, w, cap - used, ~in_sel)
        j = torch.argmax(util).view(1)          # first maximum, as jnp
        ok = torch.isfinite(util[j])            # (1,), stays on the device
        in_sel[j] = in_sel[j] | ok
        used = used + torch.where(ok, w[j][0], zero)
    return in_sel, used


# The mask value of the JAX package's attention (bf16-safe, finite).
NEG_INF = -2.0 ** 30


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """x (..., D), scale (D,): ``(x · rsqrt(mean(x²) + eps))`` in f32,
    cast to x's type, then times scale (the result takes the promoted
    type of the two, as in JAX)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def swiglu_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor):
    """x (..., D), w_gate / w_up (D, F) -> (..., F) in x's type:
    ``silu(x @ Wg) * (x @ Wu)`` with both products in f32."""
    xf = x.to(torch.float32)
    g = xf @ w_gate.to(torch.float32)
    u = xf @ w_up.to(torch.float32)
    return (torch.nn.functional.silu(g) * u).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """q (B, H, Sq, hd), k / v (B, G, Sk, hd) with H % G == 0 ->
    (B, H, Sq, hd) in q's type. Scores, softmax and the weighted sum in
    f32; masked scores are -2**30; right-aligned (query i at position
    i + Sk - Sq) when Sq < Sk."""
    B, H, Sq, hd = q.shape
    G, Sk = k.shape[1], k.shape[2]
    rep = H // G
    scale = hd ** -0.5 if scale is None else scale
    qf = q.to(torch.float32).reshape(B, G, rep, Sq, hd) * scale
    s = torch.einsum("bgrqh,bgkh->bgrqk", qf, k.to(torch.float32))
    dev = q.device
    qpos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkh->bgrqh", p, v.to(torch.float32))
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def mlstm_scan_state_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         log_f: torch.Tensor, log_i=None, *, chunk: int = 64,
                         normalize: bool = True, initial_state=None):
    """Chunkwise gated linear attention in the kernel's layout: q, k
    (B, H, S, dk), v (B, H, S, dv), gates (B, H, S) (``log_i=None``: the
    SSD form). Returns ``(out (B, H, S, dv) in v's type, {S (B, H, dk,
    dv), n (B, H, dk), m (B, H)} in f32)``, the final state stabilized
    (S_true = e^m S); ``initial_state`` (same keys) is read instead of
    zeros. Delegates to :func:`repro_torch.models.ssm.gated_linear_attention`
    on (B, S, H, d) views."""
    from ..models.ssm import gated_linear_attention
    t = lambda x: x.transpose(1, 2)
    out, state = gated_linear_attention(
        t(q), t(k), t(v), t(log_f), None if log_i is None else t(log_i),
        chunk=chunk, normalize=normalize, initial_state=initial_state)
    return t(out), state


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_f: torch.Tensor, log_i=None, *, chunk: int = 64,
                   normalize: bool = True):
    """The reference's ``ref.mlstm_scan_ref``: :func:`mlstm_scan_state_ref`'s
    output alone, (B, H, S, dv) in v's type."""
    return mlstm_scan_state_ref(q, k, v, log_f, log_i, chunk=chunk,
                                normalize=normalize)[0]
