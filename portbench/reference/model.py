"""Plain f32 forward pass of the served and trained backbone, from the
published description and the port's documented layout: SmolLM-360M
(Llama architecture): RMSNorm, GQA with rotary positions (rotate-half,
theta 10,000), causal softmax attention, SwiGLU MLP, tied embeddings.

Everything runs in f32 with TF32 off (``f32_matmuls``). ``lowp``, when
given, is a rounding (``fp8``, ``bf16``) applied to both operands and the
result of every weight product, in the forward pass and in the backward
pass's products alike (the control: the model computed in a lower
precision, rounded where the program rounds to its own type). ``lora`` adds s (x a) b to
the named products (the unmerged form of LoRA, Hu et al. 2021).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = 1e-6


@contextlib.contextmanager
def f32_matmuls():
    """TF32 off for matmuls and cuDNN inside, the caller's settings back
    on leaving."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 (e4m3) rounding of ``t``."""
    t = t.detach()
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def bf16(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 rounding of ``t``."""
    return t.detach().to(torch.bfloat16).to(torch.float32)


class _RoundedMatmul(torch.autograd.Function):
    """x @ w with the operands and the result rounded by ``rnd``, and the
    backward's two products (dy w^T, x^T dy) rounded the same way."""

    @staticmethod
    def forward(ctx, x, w, rnd):
        xr, wr = rnd(x), rnd(w)
        ctx.save_for_backward(xr, wr)
        ctx.rnd = rnd
        return rnd(xr @ wr)

    @staticmethod
    def backward(ctx, dy):
        xr, wr = ctx.saved_tensors
        rnd = ctx.rnd
        g = rnd(dy)
        dx = rnd(g @ wr.transpose(-1, -2))
        dw = rnd(xr.reshape(-1, xr.shape[-1]).t() @ g.reshape(-1, g.shape[-1]))
        return dx, dw.reshape(wr.shape), None


def rounded_matmul(x, w, rnd):
    return x @ w if rnd is None else _RoundedMatmul.apply(x, w, rnd)


def layer(params: dict, i: int) -> dict:
    if isinstance(params, dict):
        return {k: layer(v, i) for k, v in params.items()}
    return params[i]


class Model:
    """``cfg``: the benchmark's config dict. ``params``: the weight tree
    (any type; each layer is cast to f32 as it is used)."""

    def __init__(self, cfg: dict, params: dict, lowp=None):
        self.cfg, self.params, self.lowp = cfg, params, lowp
        self.hd = cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]

    def mm(self, x, w):
        return rounded_matmul(x, w.to(torch.float32), self.lowp)

    def proj(self, x, w, name, lora, i):
        """x @ W over W's leading input dim, plus LoRA's s (x a) b."""
        din = w.shape[0]
        y = self.mm(x, w.reshape(din, -1))
        if lora is not None and name in lora["targets"]:
            a, b, rnd = lora["a"][name][i], lora["b"][name][i], lora["lowp"]
            y = y + lora["scale"] * rounded_matmul(rounded_matmul(x, a, rnd),
                                                   b, rnd)
        return y

    @staticmethod
    def rmsnorm(x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) \
            * scale.to(torch.float32)

    def rope(self, x):
        S, hd = x.shape[1], x.shape[-1]
        pos = torch.arange(S, dtype=torch.float32, device=x.device)
        inv = float(self.cfg.get("rope_theta", 10000.0)) ** (
            -torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
        ang = pos[:, None] * inv[None]
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attention(self, p, h, lora, i):
        cfg, hd = self.cfg, self.hd
        B, S, _ = h.shape
        H, G = cfg["num_heads"], cfg["num_kv_heads"]
        q = self.proj(h, p["wq"], "attn/wq", lora, i).view(B, S, H, hd)
        k = self.proj(h, p["wk"], "attn/wk", lora, i).view(B, S, G, hd)
        v = self.proj(h, p["wv"], "attn/wv", lora, i).view(B, S, G, hd)
        q, k = self.rope(q), self.rope(k)
        rep = H // G
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        t = torch.arange(S, device=h.device)
        keep = t[None, :] <= t[:, None]
        s = s.masked_fill(~keep, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        return self.mm(o.reshape(B, S, H * hd), p["wo"].reshape(H * hd, -1))

    def mlp(self, p, h, lora, i):
        gate = self.proj(h, p["w_gate"], "mlp/w_gate", lora, i)
        up = self.proj(h, p["w_up"], "mlp/w_up", lora, i)
        return self.mm(F.silu(gate) * up, p["w_down"])

    def block(self, p, x, lora=None, i=0):
        h = self.rmsnorm(x, p["norm1"]["scale"])
        x = x + self.attention(p["attn"], h, lora, i)
        h = self.rmsnorm(x, p["norm2"]["scale"])
        return x + self.mlp(p["mlp"], h, lora, i)

    def hidden(self, tokens, lora=None):
        x = self.params["embed"][tokens].to(torch.float32)
        for i in range(self.cfg["num_layers"]):
            x = self.block(layer(self.params["layers"], i), x, lora, i)
        return self.rmsnorm(x, self.params["final_norm"]["scale"])

    def logits(self, x):
        if self.cfg.get("tie_embeddings"):
            return self.mm(x, self.params["embed"].t())
        return self.mm(x, self.params["lm_head"])

    def last_logits(self, tokens):
        """(B, V) logits at each prompt's last position."""
        return self.logits(self.hidden(tokens)[:, -1])

    def loss(self, tokens, targets, weights=None, lora=None):
        """Mean next-token cross-entropy a sequence, then the mean over
        sequences (weighted by ``weights`` when given)."""
        logp = torch.log_softmax(self.logits(self.hidden(tokens, lora)), -1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        per = nll.mean(-1)
        if weights is None:
            return per.mean()
        return (per * weights).sum() / weights.sum()
