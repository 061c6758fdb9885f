"""Sequence-state models: chunkwise gated linear attention (mLSTM / SSD),
sLSTM, and the xLSTM / Hymba block definitions. The JAX package's
``models/ssm.py`` in PyTorch, with the same layouts, casts and
stabilizer:

  S_t = f_t · S_{t-1} + i_t · k_t v_tᵀ         (state  (dk, dv))
  n_t = f_t · n_{t-1} + i_t · k_t              (normalizer, mLSTM only)
  h_t = (q_tᵀ S_t) / max(|q_tᵀ n_t|, 1)        (mLSTM) or q_tᵀ S_t (SSD)

computed chunk by chunk with exp-gate stabilization in log space (the
xLSTM paper's appendix). The state is kept stabilized: S_true = e^m S.

``gated_linear_attention`` and ``gla_decode_step`` are the plain oracles
of the ``mlstm_scan`` kernel. ``mlstm_block_apply`` and
``mamba_head_apply`` take a ``scan_fn`` of ``gated_linear_attention``'s
signature (the transformer passes ``kernels.mlstm_scan_bshd`` under
``cfg.use_kernels``); decode always takes the plain ``gla_decode_step``,
as the reference does. The sLSTM runs its scan over time as a Python
loop, one step a token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init, rmsnorm

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Chunkwise gated linear attention
# ---------------------------------------------------------------------------

def gated_linear_attention(q, k, v, log_f, log_i=None, *, chunk: int = 64,
                           normalize: bool = True, initial_state=None):
    """q, k: (B,S,H,dk), v: (B,S,H,dv); log_f / log_i: (B,S,H).

    Returns (out (B,S,H,dv) in v's type, final state {S (B,H,dk,dv),
    n (B,H,dk), m (B,H)} in f32). ``log_i=None`` is the SSD form (input
    gate 1); ``normalize=False`` emits q·S with no denominator.
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if S % chunk:
        pad = chunk - S % chunk
        zf = lambda x: F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
        q, k, v, log_f = map(zf, (q, k, v, log_f))
        if log_i is not None:
            log_i = zf(log_i)
        # padded steps must not change state: f = 1 (log 0), i = 0 (-inf)
        mask_t = (torch.arange(q.shape[1], device=q.device) < S)[None, :, None]
        log_f = torch.where(mask_t, log_f, 0.0)
        if log_i is None:
            log_i = torch.where(mask_t, 0.0, float("-inf")).to(log_f.dtype)
            log_i = log_i.expand(log_f.shape)
        else:
            log_i = torch.where(mask_t, log_i, float("-inf"))
    elif log_i is None:
        log_i = torch.zeros_like(log_f)
    Sp = q.shape[1]
    NC = Sp // chunk

    def chunked(x):          # (B, Sp, H, [d]) -> (NC, B, H, C, [d])
        if x.ndim == 4:
            return x.reshape(B, NC, chunk, H, -1).permute(1, 0, 3, 2, 4)
        return x.reshape(B, NC, chunk, H).permute(1, 0, 3, 2)

    qc, kc, vc = chunked(q), chunked(k), chunked(v)
    fc, ic = chunked(log_f), chunked(log_i)

    dev = q.device
    if initial_state is None:
        Sm = torch.zeros((B, H, dk, dv), dtype=_F32, device=dev)
        nm = torch.zeros((B, H, dk), dtype=_F32, device=dev)
        m_prev = torch.zeros((B, H), dtype=_F32, device=dev)
    else:
        Sm, nm, m_prev = (initial_state[n].to(_F32) for n in ("S", "n", "m"))

    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=dev))
    outs = []
    for j in range(NC):
        qj, kj, vj = qc[j].to(_F32), kc[j].to(_F32), vc[j].to(_F32)
        fj, ij = fc[j], ic[j]                      # (B,H,C)
        g = torch.cumsum(fj, dim=-1)               # inclusive log-decay
        G = g[..., -1]                             # (B,H)
        inter = g + m_prev[..., None]                               # (B,H,C)
        intra = g[..., :, None] - g[..., None, :] + ij[..., None, :]  # (B,H,C,C)
        intra = torch.where(causal, intra, float("-inf"))
        M = torch.maximum(inter, intra.amax(dim=-1))                # (B,H,C)
        M = torch.where(torch.isfinite(M), M, 0.0)
        if not normalize:
            # no denominator to cancel the stabilizer -> emit true values;
            # decays are <= 0 in the SSD case, so exp() is safe
            M = torch.zeros_like(M)
        w_inter = torch.exp(inter - M)
        w_intra = torch.exp(intra - M[..., None])
        qk = torch.einsum("bhcd,bhed->bhce", qj, kj)
        scores = qk * w_intra
        y = torch.einsum("bhce,bhed->bhcd", scores, vj) \
            + w_inter[..., None] * torch.einsum("bhcd,bhde->bhce", qj, Sm)
        if normalize:
            nrm = scores.sum(dim=-1) \
                + w_inter * torch.einsum("bhcd,bhd->bhc", qj, nm)
            denom = torch.maximum(nrm.abs(), torch.exp(-M))
            outs.append(y / denom[..., None])
        else:
            outs.append(y)
        # state update
        m_new = torch.maximum(G + m_prev,
                              (G[..., None] - g + ij).amax(dim=-1))
        m_new = torch.where(torch.isfinite(m_new), m_new, 0.0)
        decay = torch.exp(G + m_prev - m_new)                       # (B,H)
        w_k = torch.exp(G[..., None] - g + ij - m_new[..., None])   # (B,H,C)
        Sm = decay[..., None, None] * Sm \
            + torch.einsum("bhc,bhcd,bhce->bhde", w_k, kj, vj)
        nm = decay[..., None] * nm + torch.einsum("bhc,bhcd->bhd", w_k, kj)
        m_prev = m_new

    # (NC,B,H,C,dv) -> (B,H,Sp,dv) -> (B,S,H,dv)
    out = torch.stack(outs).permute(1, 2, 0, 3, 4).reshape(B, H, Sp, dv)
    out = out.transpose(1, 2)[:, :S]
    return out.to(v.dtype), {"S": Sm, "n": nm, "m": m_prev}


def gla_decode_step(q, k, v, log_f, log_i, state, *, normalize: bool = True):
    """Single-token recurrent update. q, k: (B,H,dk), v: (B,H,dv),
    log_f / log_i: (B,H); state {S, n, m}. Returns (out (B,H,dv), state)."""
    out_dtype = v.dtype
    q, k, v = q.to(_F32), k.to(_F32), v.to(_F32)
    Sm, nm, m_prev = state["S"], state["n"], state["m"]
    if log_i is None:
        log_i = torch.zeros_like(log_f)
    m_new = torch.maximum(log_f + m_prev, log_i)
    f_s = torch.exp(log_f + m_prev - m_new)
    i_s = torch.exp(log_i - m_new)
    S_new = f_s[..., None, None] * Sm + i_s[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_s[..., None] * nm + i_s[..., None] * k
    y = torch.einsum("bhd,bhde->bhe", q, S_new)
    if normalize:
        denom = torch.maximum(torch.einsum("bhd,bhd->bh", q, n_new).abs(),
                              torch.exp(-m_new))
        y = y / denom[..., None]
    else:
        # state is stored stabilized (S_true = e^m S); undo for raw output
        y = y * torch.exp(m_new)[..., None]
    return y.to(out_dtype), {"S": S_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# Causal depthwise conv (pre-QK conv of the mamba / xLSTM blocks)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, cache=None):
    """x: (B,S,D), w: (K,D) depthwise. Returns (silu(y), new_cache).

    cache (decode): (B, K-1, D), the last inputs."""
    K = w.shape[0]
    if cache is not None:
        window = torch.cat([cache, x], dim=1)              # (B, K-1+S, D)
        y = torch.einsum("bkd,kd->bd", window[:, -K:], w)[:, None]
        return F.silu(y), window[:, -(K - 1):]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return F.silu(y), None


def conv_cache_from(x, K: int):
    """The last K-1 inputs, left-padded: a fresh decode cache after
    prefill over x (B,S,D)."""
    S = x.shape[1]
    if S >= K - 1:
        return x[:, S - (K - 1):]
    return F.pad(x, (0, 0, K - 1 - S, 0))


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory recurrent, xLSTM §2.1): a loop over time
# ---------------------------------------------------------------------------

def slstm_apply(p, x, H, state=None):
    """x: (B,S,D). Gates from the input plus a block-diagonal recurrent R
    per head. Returns (out (B,S,D) in x's type, state {c, n, h, m})."""
    B, S, D = x.shape
    dh = D // H
    gates_x = torch.einsum("bsd,dg->bsg", x, p["w_gates"]) + p["b_gates"]
    gx = gates_x.reshape(B, S, 4, H, dh).to(_F32)
    if state is None:
        zeros = torch.zeros((B, H, dh), dtype=_F32, device=x.device)
        state = {"c": zeros, "n": zeros, "h": zeros, "m": zeros}
    R = p["r_gates"]              # (H, dh, 4, dh) block-diagonal recurrence
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(S):
        g = gx[:, t] + torch.einsum("bhd,hdge->bghe", h.to(x.dtype),
                                    R).to(_F32)
        i_t, f_t, z_t, o_t = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        logf = F.logsigmoid(f_t)
        m_new = torch.maximum(logf + m, i_t)
        i_s = torch.exp(i_t - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * torch.tanh(z_t)
        n = torch.clamp_min(f_s * n + i_s, 1.0)
        h = torch.sigmoid(o_t) * c / n
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    return out, {"c": c, "n": n, "h": h, "m": m}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def mlstm_block_params(cfg, gen: torch.Generator):
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    H = cfg.num_heads
    dt, dev = cfg.param_dtype, gen.device
    return {
        "norm": {"scale": torch.ones(d, dtype=dt, device=dev)},
        "w_up": dense_init(gen, (d, inner), dt),
        "w_gate": dense_init(gen, (d, inner), dt),
        "conv_w": dense_init(gen, (cfg.conv_kernel, inner), dt, scale=0.5),
        "wq": dense_init(gen, (inner, inner), dt),
        "wk": dense_init(gen, (inner, inner), dt),
        "wv": dense_init(gen, (inner, inner), dt),
        "w_if": dense_init(gen, (inner, 2 * H), dt, scale=0.01),
        "b_if": torch.cat([torch.zeros(H, device=dev),
                           torch.linspace(3.0, 6.0, H, device=dev)]).to(dt),
        "head_norm": torch.ones((H, inner // H), dtype=dt, device=dev),
        "w_down": dense_init(gen, (inner, d), dt),
    }


def _in_dtype(value: float, dtype) -> float:
    """A Python scalar rounded to ``dtype``, as JAX's weak typing rounds
    it before it multiplies an array of that type."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def mlstm_block_apply(cfg, p, x, state=None, conv_cache=None, decode=False,
                      build_cache=False, scan_fn=None):
    """xLSTM mLSTM block. Returns (out, (state, conv_cache)).
    ``scan_fn``: the chunkwise scan (default ``gated_linear_attention``)."""
    B, S, d = x.shape
    H = cfg.num_heads
    inner = cfg.ssm_expand * d
    dh = inner // H
    h = rmsnorm(x, p["norm"]["scale"])
    u = h @ p["w_up"]
    z = h @ p["w_gate"]
    c, conv_cache = causal_conv1d(u, p["conv_w"], conv_cache)
    q = (c @ p["wq"]).reshape(B, S, H, dh)
    k = (c @ p["wk"]).reshape(B, S, H, dh) * _in_dtype(dh ** -0.5, c.dtype)
    v = (u @ p["wv"]).reshape(B, S, H, dh)
    gates = (u @ p["w_if"] + p["b_if"]).to(_F32)               # (B,S,2H)
    log_i = gates[..., :H]
    log_f = F.logsigmoid(gates[..., H:])
    if decode:
        y, state = gla_decode_step(q[:, 0], k[:, 0], v[:, 0],
                                   log_f[:, 0], log_i[:, 0], state)
        y = y[:, None]
    else:
        scan = scan_fn or gated_linear_attention
        y, state = scan(q, k, v, log_f, log_i, chunk=cfg.chunk_size,
                        normalize=True, initial_state=state)
        if build_cache:
            conv_cache = conv_cache_from(u, cfg.conv_kernel)
    y = rmsnorm(y, p["head_norm"]).reshape(B, S, inner)
    out = (y * F.silu(z)) @ p["w_down"]
    return x + out, (state, conv_cache)


def slstm_block_params(cfg, gen: torch.Generator):
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    dt, dev = cfg.param_dtype, gen.device
    ff = max(1, int(d * 4 / 3) // 8 * 8)
    return {
        "norm": {"scale": torch.ones(d, dtype=dt, device=dev)},
        "w_gates": dense_init(gen, (d, 4 * d), dt),
        "b_gates": torch.cat([torch.zeros(d, device=dev),
                              torch.full((d,), 3.0, device=dev),
                              torch.zeros(2 * d, device=dev)]).to(dt),
        "r_gates": dense_init(gen, (H, dh, 4, dh), dt, scale=dh ** -0.5),
        "head_norm": torch.ones((H, dh), dtype=dt, device=dev),
        "ffn_norm": {"scale": torch.ones(d, dtype=dt, device=dev)},
        "w_ff_gate": dense_init(gen, (d, ff), dt),
        "w_ff_up": dense_init(gen, (d, ff), dt),
        "w_ff_down": dense_init(gen, (ff, d), dt),
    }


def slstm_block_apply(cfg, p, x, state=None):
    B, S, d = x.shape
    H = cfg.num_heads
    h = rmsnorm(x, p["norm"]["scale"])
    y, state = slstm_apply(p, h, H, state)
    y = rmsnorm(y.reshape(B, S, H, d // H), p["head_norm"]).reshape(B, S, d)
    x = x + y
    h = rmsnorm(x, p["ffn_norm"]["scale"])
    ff = F.silu(h @ p["w_ff_gate"]) * (h @ p["w_ff_up"])
    return x + ff @ p["w_ff_down"], state


def mamba_head_params(cfg, gen: torch.Generator):
    """Hymba's mamba heads (Mamba-2 / SSD form, scalar per-head decay)."""
    d = cfg.d_model
    H = cfg.num_heads
    N = cfg.ssm_state
    dt, dev = cfg.param_dtype, gen.device
    return {
        "w_in": dense_init(gen, (d, d), dt),
        "w_gate": dense_init(gen, (d, d), dt),
        "conv_w": dense_init(gen, (cfg.conv_kernel, d), dt, scale=0.5),
        "w_bc": dense_init(gen, (d, 2 * H * N), dt),
        "w_dt": dense_init(gen, (d, H), dt, scale=0.01),
        "b_dt": torch.log(torch.expm1(
            torch.linspace(0.001, 0.1, H, device=dev))).to(dt),
        "a_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(dt),
        "d_skip": torch.ones(H, dtype=dt, device=dev),
        "head_norm": torch.ones((H, d // H), dtype=dt, device=dev),
        "w_out": dense_init(gen, (d, d), dt),
    }


def mamba_head_apply(cfg, p, x, state=None, conv_cache=None, decode=False,
                     build_cache=False, scan_fn=None):
    """x: (B,S,D), already normed by the caller. Returns (out, (state,
    conv_cache)). ``scan_fn``: as in :func:`mlstm_block_apply`."""
    B, S, d = x.shape
    H, N = cfg.num_heads, cfg.ssm_state
    dh = d // H
    u = x @ p["w_in"]
    g = x @ p["w_gate"]
    c, conv_cache = causal_conv1d(u, p["conv_w"], conv_cache)
    bc = (c @ p["w_bc"]).reshape(B, S, 2, H, N)
    Bt, Ct = bc[:, :, 0], bc[:, :, 1]                      # (B,S,H,N)
    dt_ = F.softplus((u @ p["w_dt"]).to(_F32) + p["b_dt"].to(_F32))
    A = -torch.exp(p["a_log"].to(_F32))                    # (H,) negative
    log_decay = dt_ * A                                    # (B,S,H) <= 0
    v = u.reshape(B, S, H, dh) * dt_[..., None].to(u.dtype)
    if decode:
        y, state = gla_decode_step(Ct[:, 0], Bt[:, 0], v[:, 0],
                                   log_decay[:, 0], None, state,
                                   normalize=False)
        y = y[:, None]
    else:
        scan = scan_fn or gated_linear_attention
        y, state = scan(Ct, Bt, v, log_decay, None, chunk=cfg.chunk_size,
                        normalize=False, initial_state=state)
        if build_cache:
            conv_cache = conv_cache_from(u, cfg.conv_kernel)
    y = y + u.reshape(B, S, H, dh) * p["d_skip"][:, None]
    y = rmsnorm(y, p["head_norm"]).reshape(B, S, d)
    return (y * F.silu(g)) @ p["w_out"], (state, conv_cache)
