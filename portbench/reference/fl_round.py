"""A federated LoRA round in plain f32, written again from the paper
(arXiv 2312.14941 §III: FedAvg with p_k = n_k / sum n_k, local SGD, the
server step w <- w - eta Delta_t, the quality cosine q_k = cos(Delta_k,
Delta_t)) and from the JAX package's data plane: each (round, slot)
draws its batch positions from JAX's counter-based threefry2x32 keyed
by fold_in(fold_in(key(seed), round), slot), then split, then uniform,
so slot k's batches depend only on (seed, round, k).

Threefry2x32 (Salmon et al., SC 2011, 20 rounds) is written here in
numpy on uint32 words; JAX's ``PRNGKey(seed)`` is (seed >> 32, seed &
0xffffffff), ``fold_in(key, x)`` hashes (0, x), ``split(key)[i]`` hashes
(0, i), and ``uniform`` puts the top 23 bits of (y0 ^ y1) of the flat
index's counter into the mantissa of a float in [1, 2), minus one.
"""
from __future__ import annotations

import numpy as np
import torch

from .model import Model

_M = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return ((x << np.uint64(d)) | (x >> np.uint64(32 - d))) & _M


def threefry(k0, k1, x0, x1):
    k0, k1 = np.uint64(k0), np.uint64(k1)
    x0 = np.asarray(x0, np.uint64)
    x1 = np.asarray(x1, np.uint64)
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(0x1BD11BDA))
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M
    return x0, x1


def key(seed: int):
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def fold_in(k, x: int):
    y0, y1 = threefry(k[0], k[1], 0, x)
    return int(y0), int(y1)


def split2(k):
    y0, y1 = threefry(k[0], k[1], [0, 0], [0, 1])
    return (int(y0[0]), int(y1[0])), (int(y0[1]), int(y1[1]))


def uniform(k, n: int) -> np.ndarray:
    idx = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry(k[0], k[1], idx >> np.uint64(32), idx & _M)
    bits = ((y0 ^ y1) >> np.uint64(9)) | np.uint64(0x3F800000)
    return np.maximum(bits.astype(np.uint32).view(np.float32)
                      - np.float32(1.0), np.float32(0.0))


def batch_indices(seed: int, rnd: int, slot: int, size: int, steps: int,
                  batch: int) -> np.ndarray:
    """(steps, batch) positions in [0, size) into a client's samples."""
    k = fold_in(fold_in(key(seed), rnd), slot)
    u = uniform(split2(k)[1], steps * batch).reshape(steps, batch)
    pos = np.floor(u * np.float32(size)).astype(np.int64)
    return np.clip(pos, 0, size - 1)


def flat(tree: dict) -> torch.Tensor:
    return torch.cat([tree[n].reshape(-1) for n in sorted(tree)])


class LoraRound:
    """The task's rounds from given adapters: ``run(rnd, subset,
    weights)`` trains, aggregates and steps the server; it returns the
    round's mean loss, the q cosines and the aggregate."""

    def __init__(self, cfg: dict, base: dict, adapters: dict, *, tokens,
                 parts, seed: int, rank: int, alpha: float, steps: int,
                 batch: int, local_lr: float, server_lr: float, lowp=None,
                 adapter_lowp=None):
        self.model = Model(cfg, base, lowp)
        self.adapters = {n: v.detach().to(torch.float32).clone()
                         for n, v in adapters.items()}
        self.targets = sorted({n.rsplit("/", 1)[0] for n in adapters})
        self.tokens, self.parts, self.seed = tokens, parts, seed
        self.scale, self.steps, self.batch = alpha / rank, steps, batch
        self.local_lr, self.server_lr = local_lr, server_lr
        self.adapter_lowp = adapter_lowp

    def _lora(self, ad):
        return {"targets": self.targets, "scale": self.scale,
                "a": {t: ad[t + "/a"] for t in self.targets},
                "b": {t: ad[t + "/b"] for t in self.targets},
                "lowp": self.adapter_lowp}

    def client(self, rnd: int, slot: int, cid: int):
        part = self.parts[cid]
        pos = batch_indices(self.seed, rnd, slot, len(part), self.steps,
                            self.batch)
        p = {n: v.clone().requires_grad_() for n, v in self.adapters.items()}
        losses = []
        dev = next(iter(p.values())).device
        for e in range(self.steps):
            seqs = torch.as_tensor(self.tokens[part[pos[e]]], dtype=torch.int64,
                                   device=dev)
            loss = self.model.loss(seqs[:, :-1], seqs[:, 1:],
                                   lora=self._lora(p))
            grads = torch.autograd.grad(loss, [p[n] for n in sorted(p)])
            with torch.no_grad():
                for n, g in zip(sorted(p), grads):
                    p[n] -= self.local_lr * g
            losses.append(float(loss.detach()))
        delta = {n: (self.adapters[n] - p[n]).detach() for n in p}
        return delta, float(np.mean(losses))

    def run(self, rnd: int, subset, weights):
        w = np.asarray(weights, np.float64)
        w = w / max(w.sum(), 1e-9)
        deltas, losses = [], []
        for slot, cid in enumerate(subset):
            d, l = self.client(rnd, slot, int(cid))
            deltas.append(d)
            losses.append(l)
        agg = {n: sum(float(wk) * d[n] for wk, d in zip(w, deltas))
               for n in self.adapters}
        fa = flat(agg)
        q = [float(torch.dot(flat(d), fa)
                   / (flat(d).norm() * fa.norm()).clamp_min(1e-12))
             for d in deltas]
        with torch.no_grad():
            for n in self.adapters:
                self.adapters[n] -= self.server_lr * agg[n]
        return float(np.dot(w, losses)), np.array(q), agg
