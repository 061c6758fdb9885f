"""Mixture-of-Experts FFN (Qwen1.5-MoE: 60 experts top-4 + 4 shared;
Llama-4-Scout: 16 experts top-1 + 1 shared): the JAX package's
``models/moe.py`` in PyTorch.

Token-choice top-k routing with capacity-bounded scatter dispatch:
tokens are scattered into a dense per-expert buffer (E, C, d), the
expert FFNs are batched matrix products over it, and the routes past an
expert's capacity C are dropped (the residual carries those tokens), as
in Switch. A Switch-style load-balance loss is returned beside the
output.

The routing is the reference's to the bit: logits in f32, padded
experts at -1e30, top-k by a stable descending sort (the lowest expert
index first on ties, as ``lax.top_k``), each route's position in its
expert by a cumulative sum over the routes in token-major, k-minor
order, so the same routes are kept and dropped. Every step is on the
tensor's device, with no copy to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import dense_init


def padded_experts(cfg) -> int:
    return max(cfg.pad_experts_to, cfg.num_experts)


def moe_params(cfg, gen: torch.Generator):
    """Router (d, E) in f32 at scale 0.02; experts (E, d, ff) and (E, ff,
    d) at ``dense_init``'s scale, whose fan-in is the leading axis (E),
    as in the reference; the shared experts as one SwiGLU MLP of width
    ``num_shared_experts * moe_d_ff``."""
    d, E = cfg.d_model, padded_experts(cfg)
    ff = cfg.moe_d_ff
    dt = cfg.param_dtype
    p = {"router": dense_init(gen, (d, E), torch.float32, scale=0.02),
         "w_gate": dense_init(gen, (E, d, ff), dt),
         "w_up": dense_init(gen, (E, d, ff), dt),
         "w_down": dense_init(gen, (E, ff, d), dt)}
    if cfg.num_shared_experts:
        sff = cfg.num_shared_experts * ff
        p["shared"] = {"w_gate": dense_init(gen, (d, sff), dt),
                       "w_up": dense_init(gen, (d, sff), dt),
                       "w_down": dense_init(gen, (sff, d), dt)}
    return p


def _capacity(tokens: int, num_experts: int, top_k: int,
              factor: float) -> int:
    cap = int(tokens * top_k * factor / num_experts)
    return max(cap, top_k)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, descending, ties to the lowest index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_probs(cfg, p, xt, mask_padded: bool = True):
    """The router's softmax over the experts, in f32: (T, E)."""
    logits = xt.to(torch.float32) @ p["router"]                  # (T, E)
    E = logits.shape[-1]
    if mask_padded and E > cfg.num_experts:
        pad = torch.arange(E, device=xt.device) >= cfg.num_experts
        logits = logits.masked_fill(pad, -1e30)
    return torch.softmax(logits, dim=-1)


class Routing(NamedTuple):
    gates: torch.Tensor        # (T, K) f32, renormalised
    expert_idx: torch.Tensor   # (T, K) int64
    aux: torch.Tensor          # () f32, the weighted load-balance loss
    capacity: int              # C, slots an expert
    pos: torch.Tensor          # (T*K,) int64, each route's slot in its expert
    keep: torch.Tensor         # (T*K,) bool, pos < C


def routing(cfg, p, xt: torch.Tensor) -> Routing:
    """Route the tokens xt (T, d): top-k gates, the auxiliary loss, and
    each route's slot in its expert and whether it is kept."""
    probs = router_probs(cfg, p, xt)
    return route(cfg, probs, _top_k(probs, cfg.top_k)[1])


def route(cfg, probs: torch.Tensor, expert_idx: torch.Tensor) -> Routing:
    """What follows from each token's chosen experts expert_idx (T, K),
    given the router's probs (T, E): the gates (the chosen probabilities,
    renormalised), the auxiliary loss, and each route's slot and drop."""
    T, K = expert_idx.shape
    E = probs.shape[-1]
    gates = probs.gather(1, expert_idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # routes in token-major, k-minor order; an expert's row of the (E,
    # T*K) one-hot counts its routes (the load-balance loss) and, summed
    # along to a route, gives that route's 0-based slot (the reference's
    # cumsum down the (T*K, E) one-hot, along the contiguous axis here)
    flat_e = expert_idx.reshape(T * K)
    onehot = (torch.arange(E, device=probs.device)[:, None]
              == flat_e[None, :]).long()
    me = probs.mean(dim=0)                                      # (E,)
    ce = onehot.sum(dim=1).to(torch.float32) / (T * K)
    aux = E * (me * ce).sum() * cfg.router_aux_weight

    C = _capacity(T, E, K, cfg.capacity_factor)
    pos = onehot.cumsum(dim=1).gather(0, flat_e[None, :])[0] - 1
    return Routing(gates, expert_idx, aux, C, pos, pos < C)


def moe_ffn(cfg, p, x):
    """x: (B, S, d). Returns (out, aux_loss)."""
    B, S, d = x.shape
    E, K = padded_experts(cfg), cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    r = routing(cfg, p, xt)
    C = r.capacity

    # scatter the kept routes into (E, C, d); a dropped route adds zeros
    # at slot C - 1, and kept routes land on distinct slots, so the
    # accumulating scatter is exact
    flat_e = r.expert_idx.reshape(T * K)
    safe_pos = torch.where(r.keep, r.pos, C - 1)
    src = xt.repeat_interleave(K, dim=0).masked_fill(~r.keep[:, None], 0)
    buf = x.new_zeros((E, C, d))
    buf.index_put_((flat_e, safe_pos), src, accumulate=True)

    # the expert FFNs: batched products (E, C, ff)
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"])                        # (E, C, d)

    # gather back and combine with the gates
    y = out_buf[flat_e, safe_pos]                              # (TK, d)
    w = (r.gates.reshape(T * K) * r.keep).to(x.dtype)
    y = (y * w[:, None]).reshape(T, K, d).sum(dim=1)

    if cfg.num_shared_experts:
        y = y + _shared(p["shared"], xt)
    return y.reshape(B, S, d), r.aux


def _shared(sp, xt):
    hs = F.silu(xt @ sp["w_gate"]) * (xt @ sp["w_up"])
    return hs @ sp["w_down"]


def moe_ffn_dense(cfg, p, x):
    """Oracle: every token through every expert, weighted by its top-k
    gates (no capacity drops). O(E·T·ff); for tests only."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    xt = x.reshape(-1, d)
    probs = router_probs(cfg, p, xt, mask_padded=False)
    gates, expert_idx = _top_k(probs, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    full = torch.zeros(xt.shape[0], E, dtype=torch.float32, device=x.device)
    full.scatter_add_(1, expert_idx, gates)
    h = F.silu(torch.einsum("td,edf->tef", xt, p["w_gate"])) \
        * torch.einsum("td,edf->tef", xt, p["w_up"])
    per_expert = torch.einsum("tef,efd->ted", h, p["w_down"])
    y = torch.einsum("ted,te->td", per_expert, full.to(x.dtype))
    if cfg.num_shared_experts:
        y = y + _shared(p["shared"], xt)
    return y.reshape(B, S, d)
