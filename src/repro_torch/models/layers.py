"""Shared neural layers: norms, RoPE, GQA attention (causal / sliding
window), MLPs, init helpers. The JAX package's ``models/layers.py`` in
PyTorch: plain functions on tensors, parameters in plain dicts, the same
weight layouts:

  wq: (d_model, H, hd)    wk/wv: (d_model, G, hd)    wo: (H, hd, d_model)
  w_gate/w_up: (d_model, d_ff)    w_down: (d_ff, d_model)

Where the reference multiplies tensors of two types (the stub frontends'
f32 embeddings through bf16 weights, and so Whisper's whole encoder and
its cross-attention K/V), ``jnp`` computes in the promoted type;
:func:`promoted` does that here, and leaves a product of one type as it
is. Decode updates the KV cache's tensors in place (the reference builds
new arrays): a cache passed to :func:`cache_attend` with new K/V is
returned, changed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ref import NEG_INF


def promoted(*tensors):
    """The tensors in their promoted type (``torch.promote_types``), as
    ``jnp`` promotes the operands of a product; unchanged when they
    share a type."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in tensors)


def matmul(a, b):
    """``a @ b`` in the operands' promoted type."""
    a, b = promoted(a, b)
    return a @ b


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    """The model's RMSNorm: rsqrt(mean(x²) + eps) in f32, cast to x's type
    before it multiplies x (``kernels.ref.rmsnorm_ref`` casts after)."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def apply_norm(cfg, p, x, kernels=None):
    """The config's norm. With a ``kernels`` namespace (the transformer
    passes one when ``cfg.use_kernels``), RMSNorm is ``kernels.rmsnorm``."""
    if cfg.norm == "rmsnorm":
        if kernels is not None:
            return kernels.rmsnorm(x, p["scale"])
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    # a Python-scalar base: no host-to-device copy (it would stall the
    # host on the card's queue once a layer)
    exponent = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return torch.pow(float(theta), exponent)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(seq_len: int, d_model: int, dtype=torch.float32,
                         device=None):
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    angle = pos / torch.pow(10_000.0, dim / d_model)
    emb = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return emb[:, :d_model].to(dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_mask(q_positions, k_positions, causal: bool, window: int):
    """(..., Sq, Sk) boolean mask: True = attend."""
    qp = q_positions[..., :, None]
    kp = k_positions[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=qp.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return mask


def dot_product_attention(q, k, v, mask=None, soft_cap: float = 0.0):
    """q: (B,Sq,H,hd), k/v: (B,Sk,G,hd) with H = G*rep (GQA).

    ``mask`` is boolean, broadcastable to (B, 1, Sq, Sk); True = attend.
    """
    B, Sq, H, hd = q.shape
    G = k.shape[2]
    rep = H // G
    qf = q.to(torch.float32) * (hd ** -0.5)
    qf = qf.reshape(B, Sq, G, rep, hd)
    scores = torch.einsum("bqgrh,bkgh->bgrqk", qf, k.to(torch.float32))
    if soft_cap > 0:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, :, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def chunked_attention(q, k, v, positions, *, causal: bool, window: int,
                      soft_cap: float = 0.0, q_chunk: int = 1024):
    """Q-chunked attention: :func:`dot_product_attention`'s math with the
    scores of one (B, H, q_chunk, Sk) block at a time (a loop over query
    blocks; the reference scans them). Padded queries mask every key."""
    B, Sq, H, hd = q.shape
    C = min(q_chunk, Sq)
    if Sq % C:
        pad = C - Sq % C
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        positions = F.pad(positions, (0, pad), value=-1)
    k_pos = positions[:, :k.shape[1]]
    outs = []
    for start in range(0, q.shape[1], C):
        qb, pb = q[:, start:start + C], positions[:, start:start + C]
        mask = attention_mask(pb, k_pos, causal, window)[:, None]
        mask &= (pb >= 0)[:, None, :, None]
        outs.append(dot_product_attention(qb, k, v, mask, soft_cap))
    return torch.cat(outs, dim=1)[:, :Sq]


def qkv_project(p, x, kv_source=None):
    """Q from x, K and V from ``kv_source`` (default x)."""
    src = x if kv_source is None else kv_source
    q = torch.einsum("bsd,dhk->bshk", *promoted(x, p["wq"]))
    k = torch.einsum("bsd,dgk->bsgk", *promoted(src, p["wk"]))
    v = torch.einsum("bsd,dgk->bsgk", *promoted(src, p["wv"]))
    return q, k, v


def out_project(p, o):
    return torch.einsum("bshk,hkd->bsd", *promoted(o, p["wo"]))


def build_kv_cache(k, v, positions, window: int = 0):
    """Build a (ring-buffer) KV cache from prefill K/V.

    k/v: (B, S, G, hd); positions: (B, S). With a sliding ``window`` the
    cache keeps only the last min(S, window) entries at slot
    ``pos % window`` (ring layout); otherwise capacity == S at slot = pos.
    ``pos`` records each slot's absolute position (-1 = empty).
    """
    B, S = k.shape[:2]
    if window <= 0 or window >= S:
        cap = S if window <= 0 else window
        pad = cap - S
        cpos = positions[0].to(torch.int32)
        if pad:
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
            cpos = F.pad(cpos, (0, pad), value=-1)
        return {"k": k, "v": v, "pos": cpos}
    # ring layout: the last `window` tokens, slot = pos % window (unique)
    kw, vw = k[:, -window:], v[:, -window:]
    pos = positions[0, -window:].to(torch.int32)
    slots = (pos % window).long()
    ck = k.new_zeros((B, window) + tuple(k.shape[2:]))
    cv = v.new_zeros((B, window) + tuple(v.shape[2:]))
    ck[:, slots] = kw
    cv[:, slots] = vw
    cpos = torch.full((window,), -1, dtype=torch.int32, device=k.device)
    cpos[slots] = pos
    return {"k": ck, "v": cv, "pos": cpos}


def cache_attend(cfg, q, kv_cache, q_positions, window: int,
                 new_k=None, new_v=None):
    """Attend queries against a KV cache, inserting this step's K/V first
    (decode; in place). q: (B,Sq,H,hd); q_positions: (B,Sq)."""
    ck, cv, cpos = kv_cache["k"], kv_cache["v"], kv_cache["pos"]
    cap = ck.shape[1]
    if new_k is not None:
        wpos = q_positions[0].to(torch.int32)       # (Sq,) new absolute pos
        slots = (wpos % cap).long()
        ck[:, slots] = new_k.to(ck.dtype)
        cv[:, slots] = new_v.to(cv.dtype)
        cpos[slots] = wpos
    valid = (cpos[None, None, :] >= 0) \
        & (cpos[None, None, :] <= q_positions[:, :, None])
    if window > 0:
        valid &= cpos[None, None, :] > q_positions[:, :, None] - window
    o = dot_product_attention(q, ck, cv, valid[:, None], cfg.logit_soft_cap)
    return o, {"k": ck, "v": cv, "pos": cpos}


def self_attention(cfg, p, x, positions, *, causal=True, window=None,
                   kv_cache=None, build_cache=False, flash_fn=None):
    """Self-attention sublayer.

    Returns (out, cache): cache is None in plain training mode, a fresh
    cache dict when ``build_cache`` (prefill), or the updated cache when
    ``kv_cache`` is given (decode).
    """
    window = cfg.sliding_window if window is None else window
    q, k, v = qkv_project(p, x)
    if cfg.positional == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:   # decode: insert new K/V, attend to cache
        o, new_cache = cache_attend(cfg, q, kv_cache, positions, window,
                                    new_k=k, new_v=v)
        return out_project(p, o), new_cache

    if flash_fn is not None:
        o = flash_fn(q, k, v, causal=causal, window=window)
    elif x.shape[1] >= 4096:
        # long sequences: q-chunked attention (no (S,S) materialization)
        o = chunked_attention(q, k, v, positions, causal=causal,
                              window=window, soft_cap=cfg.logit_soft_cap)
    else:
        mask = attention_mask(positions, positions, causal, window)[:, None]
        o = dot_product_attention(q, k, v, mask, cfg.logit_soft_cap)
    cache = build_kv_cache(k, v, positions, window) if build_cache else None
    return out_project(p, o), cache


def cross_attention(cfg, p, x, memory):
    """Decoder-to-encoder attention (Whisper). memory: (B, S_enc, D), its
    K and V computed afresh at every call, as in the reference (no
    cross-attention cache)."""
    q, k, v = qkv_project(p, x, memory)
    o = dot_product_attention(q, k, v, mask=None, soft_cap=cfg.logit_soft_cap)
    return out_project(p, o)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(cfg, p, x, swiglu_fn=None):
    if cfg.act == "swiglu":
        if swiglu_fn is not None:
            h = swiglu_fn(x, p["w_gate"], p["w_up"])
        else:
            h = F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    else:  # gelu
        h = F.gelu(matmul(x, p["w_up"]), approximate="tanh")
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# Init helpers: normal draws from an explicit generator at the reference's
# scales (fan_in ** -0.5 unless given), drawn in f32 and cast.
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale=None):
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(scale).to(dtype)      # in place: one f32 draw at a time


def norm_params(cfg, device):
    p = {"scale": torch.ones(cfg.d_model, dtype=cfg.param_dtype,
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, dtype=cfg.param_dtype,
                                device=device)
    return p


def attn_params(cfg, gen: torch.Generator):
    d, H, G, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    dt = cfg.param_dtype
    return {
        "wq": dense_init(gen, (d, H, hd), dt),
        "wk": dense_init(gen, (d, G, hd), dt),
        "wv": dense_init(gen, (d, G, hd), dt),
        "wo": dense_init(gen, (H, hd, d), dt, scale=(H * hd) ** -0.5),
    }


def mlp_params(cfg, gen: torch.Generator, d_ff=None):
    d = cfg.d_model
    d_ff = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    p = {}
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(gen, (d, d_ff), dt)
    p["w_up"] = dense_init(gen, (d, d_ff), dt)
    p["w_down"] = dense_init(gen, (d_ff, d), dt)
    return p
