"""Synthetic datasets (generated offline from a seed).

``make_classification_data`` produces MNIST-like / CIFAR-like image
classification data: each class has a smooth random prototype image;
samples are prototype + noise (+ random shift for the CIFAR-like
difficulty bump). A CNN can learn it, accuracy ordering matches the
paper's (CIFAR-like harder), and labels are explicit so the paper's
non-iid partitions (Type 1/2/3) apply exactly.

``make_lm_data`` produces token streams from a class-conditional bigram
process so LM architectures have a learnable federated task whose
"label" histogram (bigram-bucket histogram) feeds the scheduler.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClassificationData:
    images: np.ndarray      # (N, H, W, C) float32 in [0,1]
    labels: np.ndarray      # (N,) int32
    num_classes: int

    def subset(self, idx):
        return ClassificationData(self.images[idx], self.labels[idx],
                                  self.num_classes)


def make_classification_data(kind: str, n: int, seed: int = 0,
                             num_classes: int = 10) -> ClassificationData:
    """kind: 'mnist' (28x28x1, easy) or 'cifar' (32x32x3, harder)."""
    rng = np.random.default_rng(seed)
    if kind == "mnist":
        H = W = 28
        C, noise, shift = 1, 0.30, 0
    elif kind == "cifar":
        H = W = 32
        C, noise, shift = 3, 0.55, 4
    else:
        raise ValueError(kind)

    # smooth class prototypes: low-frequency random fields
    freq = 4
    base = rng.normal(size=(num_classes, freq, freq, C))
    protos = np.zeros((num_classes, H, W, C), np.float32)
    for c in range(num_classes):
        for ch in range(C):
            up = np.kron(base[c, :, :, ch], np.ones((H // freq + 1,
                                                     W // freq + 1)))
            protos[c, :, :, ch] = up[:H, :W]
    protos = (protos - protos.min()) / (np.ptp(protos) + 1e-9)

    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = protos[labels].copy()
    if shift:  # random translations make the task harder (CIFAR-like)
        for i in range(n):
            sx, sy = rng.integers(-shift, shift + 1, size=2)
            images[i] = np.roll(np.roll(images[i], sx, 0), sy, 1)
    images += rng.normal(scale=noise, size=images.shape).astype(np.float32)
    images = np.clip(images, 0.0, 1.0)
    return ClassificationData(images.astype(np.float32), labels, num_classes)


@dataclasses.dataclass
class LMData:
    tokens: np.ndarray      # (N, S+1) int32; input = [:, :-1], target = [:, 1:]
    labels: np.ndarray      # (N,) int32 latent class of each sequence
    num_classes: int
    vocab_size: int


def make_lm_data(n: int, seq_len: int, vocab_size: int, seed: int = 0,
                 num_classes: int = 10) -> LMData:
    """Class-conditional deterministic-ish bigram streams.

    Each latent class c has its own random permutation pi_c; sequences
    follow t_{k+1} = pi_c(t_k) with occasional noise. The latent class is
    the scheduler's 'label'."""
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(vocab_size) for _ in range(num_classes)])
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    toks = np.zeros((n, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab_size, size=n)
    noise = rng.uniform(size=(n, seq_len)) < 0.05
    for k in range(seq_len):
        nxt = perms[labels, toks[:, k]]
        rand = rng.integers(0, vocab_size, size=n)
        toks[:, k + 1] = np.where(noise[:, k], rand, nxt)
    return LMData(toks, labels, num_classes, vocab_size)


def histogram(labels: np.ndarray, num_classes: int) -> np.ndarray:
    return np.bincount(labels, minlength=num_classes).astype(np.float64)
