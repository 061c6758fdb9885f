"""Optimizers in PyTorch over flat parameter dicts: SGD, momentum, Adam,
AdamW, and the server-side federated pair FedAdam/FedYogi.

The interface mirrors the JAX package's (and optax's): ``init(params)
-> state``, ``update(grads, state, params) -> (updates, state)``; apply
with :func:`apply_updates`. Parameters, gradients and updates are
``dict[str, Tensor]``; a state is a dict holding an int32 ``count`` and
f32 moment dicts (``mu``, or ``m`` and ``v``) on the parameters' device.
Every function returns new tensors and changes none in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params: dict, updates: dict) -> dict:
    return {n: (p + updates[n]).to(p.dtype) for n, p in params.items()}


def _scalar_lr(lr, count):
    return lr(count) if callable(lr) else lr


def _zeros_f32(params: dict) -> dict:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


def _count0(params: dict) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        state = {"count": _count0(params)}
        if momentum:
            state["mu"] = _zeros_f32(params)
        return state

    def update(grads, state, params=None):
        count = state["count"] + 1
        step = _scalar_lr(lr, count)
        if momentum:
            mu = {n: momentum * m + grads[n].to(torch.float32)
                  for n, m in state["mu"].items()}
            if nesterov:
                upd = {n: -(step * (momentum * m + grads[n]))
                       for n, m in mu.items()}
            else:
                upd = {n: -step * m for n, m in mu.items()}
            return upd, {"count": count, "mu": mu}
        return {n: -step * g for n, g in grads.items()}, {"count": count}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, grad_clip: float = 0.0) -> Optimizer:
    """Adam/AdamW with optional global-norm clipping."""

    def init(params):
        return {"count": _count0(params), "m": _zeros_f32(params),
                "v": _zeros_f32(params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        step = _scalar_lr(lr, count)
        if grad_clip > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-9),
                                    1.0)
            grads = {n: g * scale for n, g in grads.items()}
        m = {n: b1 * m_ + (1 - b1) * grads[n].to(torch.float32)
             for n, m_ in state["m"].items()}
        v = {n: b2 * v_ + (1 - b2) * torch.square(grads[n].to(torch.float32))
             for n, v_ in state["v"].items()}
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)

        def upd(n):
            u = -step * (m[n] / c1) / (torch.sqrt(v[n] / c2) + eps)
            if weight_decay and params is not None:
                u = u - step * weight_decay * params[n].to(torch.float32)
            return u

        return {n: upd(n) for n in m}, {"count": count, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    return adam(lr, b1, b2, eps, weight_decay, grad_clip)


def _fedopt(lr, b1: float, b2: float, eps: float, yogi: bool) -> Optimizer:
    """Shared FedAdam/FedYogi core (Reddi et al., *Adaptive Federated
    Optimization*, 2021). The "gradient" fed in is the server
    pseudo-gradient Δ_t = Σ_k p_k (w_t − w_t^(k)); no bias correction,
    per the paper's server-side variant. FedYogi's second moment moves
    additively toward g² (``v − (1−b2)·sign(v − g²)·g²``) instead of the
    exponential average, which keeps v from inflating under the sparse,
    bursty pseudo-gradients that compressed client updates produce.
    """

    def init(params):
        return {"count": _count0(params), "m": _zeros_f32(params),
                "v": _zeros_f32(params)}

    def vupd(v_, g):
        g2 = torch.square(g.to(torch.float32))
        if yogi:
            return v_ - (1 - b2) * torch.sign(v_ - g2) * g2
        return b2 * v_ + (1 - b2) * g2

    def update(grads, state, params=None):
        count = state["count"] + 1
        step = _scalar_lr(lr, count)
        m = {n: b1 * m_ + (1 - b1) * grads[n].to(torch.float32)
             for n, m_ in state["m"].items()}
        v = {n: vupd(v_, grads[n]) for n, v_ in state["v"].items()}
        updates = {n: -step * m[n] / (torch.sqrt(v[n]) + eps) for n in m}
        return updates, {"count": count, "m": m, "v": v}

    return Optimizer(init, update)


def fedadam(lr, b1: float = 0.9, b2: float = 0.99,
            eps: float = 1e-3) -> Optimizer:
    """Server-side Adam over the FedAvg pseudo-gradient Δ_t."""
    return _fedopt(lr, b1, b2, eps, yogi=False)


def fedyogi(lr, b1: float = 0.9, b2: float = 0.99,
            eps: float = 1e-3) -> Optimizer:
    """Server-side Yogi over the FedAvg pseudo-gradient Δ_t."""
    return _fedopt(lr, b1, b2, eps, yogi=True)


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


GETTERS = {"sgd": sgd, "adam": adam, "adamw": adamw,
           "fedadam": fedadam, "fedyogi": fedyogi}


def make(name: str, lr, **kw) -> Optimizer:
    return GETTERS[name](lr, **kw)
