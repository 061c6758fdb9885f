"""A FedSGD step in plain f32: the weighted next-token loss of the
scheduled clients' rows (each row weighted p_k / its client's rows, so
the gradient is FedAvg's sum over p_k for one local step), its gradient
by autograd over every parameter, global-norm clipping, and Adam
(Kingma & Ba 2015) under a linear warm-up into a cosine decay, written
again from the paper and the JAX package's equations."""
from __future__ import annotations

import math

import torch

from .model import Model


def flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def warmup_cosine(peak: float, warmup: int, total: int, count: int) -> float:
    if count < warmup:
        return peak * count / max(warmup, 1)
    t = min(max((count - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return 0.5 * peak * (1 + math.cos(math.pi * t))


class FedSGD:
    def __init__(self, cfg: dict, params: dict, *, lr: float, warmup: int,
                 total: int, clip: float, rows: int, lowp=None,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.cfg, self.lowp, self.rows = cfg, lowp, rows
        self.p = {n: v.detach().to(torch.float32).clone()
                  for n, v in flatten(params).items()}
        self.m = {n: torch.zeros_like(v) for n, v in self.p.items()}
        self.v = {n: torch.zeros_like(v) for n, v in self.p.items()}
        self.lr, self.warmup, self.total, self.clip = lr, warmup, total, clip
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0

    def grads(self, batch):
        """(loss, gradient) of the weighted loss, summed over blocks of
        ``rows`` rows."""
        live = {n: v.clone().requires_grad_() for n, v in self.p.items()}
        model = Model(self.cfg, unflatten(live), self.lowp)
        w = batch["weights"].to(torch.float32)
        total_w = w.sum()
        g = {n: torch.zeros_like(v) for n, v in self.p.items()}
        loss = 0.0
        for r in range(0, w.shape[0], self.rows):
            sl = slice(r, r + self.rows)
            part = model.loss(batch["tokens"][sl], batch["targets"][sl],
                              weights=w[sl]) * (w[sl].sum() / total_w)
            gs = torch.autograd.grad(part, [live[n] for n in sorted(live)])
            for n, gi in zip(sorted(live), gs):
                g[n] += gi
            loss += float(part.detach())
        return loss, g

    def step(self, batch):
        """One step; returns (loss, the clipped gradient Adam took)."""
        loss, g = self.grads(batch)
        norm = math.sqrt(sum(float(x.square().sum()) for x in g.values()))
        scale = min(1.0, self.clip / max(norm, 1e-9))
        g = {n: x * scale for n, x in g.items()}
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        lr = warmup_cosine(self.lr, self.warmup, self.total, self.count)
        with torch.no_grad():
            for n in self.p:
                self.m[n].mul_(self.b1).add_(g[n], alpha=1 - self.b1)
                self.v[n].mul_(self.b2).addcmul_(g[n], g[n], value=1 - self.b2)
                self.p[n] -= lr * (self.m[n] / c1) / (
                    torch.sqrt(self.v[n] / c2) + self.eps)
        return loss, g
