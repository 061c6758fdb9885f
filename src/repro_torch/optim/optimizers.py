"""Optimizers in PyTorch over trees of tensors: SGD, momentum, Adam,
AdamW, and the server-side federated pair FedAdam/FedYogi.

The interface mirrors the JAX package's (and optax's): ``init(params)
-> state``, ``update(grads, state, params) -> (updates, state)``; apply
with :func:`apply_updates`. Parameters, gradients and updates are
nested dicts and lists of tensors (a round plane's flat
``dict[str, Tensor]``, or a transformer's tree); a state is a dict
holding an int32 ``count`` and f32 moment trees (``mu``, or ``m`` and
``v``) on the parameters' device. Every function returns new tensors and
changes none in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts and lists, with the
    matching leaves of the ``rest`` trees as further arguments (a
    ``None`` rest tree passes ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(None if r is None else r[k]
                                     for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(None if r is None else r[i]
                                             for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves in JAX's order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _scalar_lr(lr, count):
    return lr(count) if callable(lr) else lr


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _count0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
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
            mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                          state["mu"], grads)
            if nesterov:
                upd = tree_map(lambda m, g: -(step * (momentum * m + g)),
                               mu, grads)
            else:
                upd = tree_map(lambda m: -step * m, mu)
            return upd, {"count": count, "mu": mu}
        return tree_map(lambda g: -step * g, grads), {"count": count}

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
            # the f32 scale promotes a bf16 gradient to f32, as in jnp
            grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)

        def upd(m_, v_, p):
            u = -step * (m_ / c1) / (torch.sqrt(v_ / c2) + eps)
            if weight_decay and p is not None:
                u = u - step * weight_decay * p.to(torch.float32)
            return u

        return tree_map(upd, m, v, params), {"count": count, "m": m, "v": v}

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
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(vupd, state["v"], grads)
        updates = tree_map(lambda m_, v_: -step * m_ / (torch.sqrt(v_) + eps),
                           m, v)
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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


GETTERS = {"sgd": sgd, "adam": adam, "adamw": adamw,
           "fedadam": fedadam, "fedyogi": fedyogi}


def make(name: str, lr, **kw) -> Optimizer:
    return GETTERS[name](lr, **kw)
