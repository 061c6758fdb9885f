"""Inputs made from the seed: the federated LM data (class-conditional
bigram streams), its non-iid partition, and prompts. The bigram
generator and the Type-2 partition are frozen copies of the port's
``data.synthetic.make_lm_data`` and ``fl.partition.partition_labels``
(paper §VIII-A); the benchmark makes the data and hands the same to the
program and to the reference."""
from __future__ import annotations

import numpy as np
import torch


def lm_data(n: int, seq_len: int, vocab: int, seed: int,
            num_classes: int = 10):
    """(tokens (n, S+1) int32, labels (n,) int32): each latent class
    follows its own permutation of the vocabulary, with 5 % noise."""
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(vocab) for _ in range(num_classes)])
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    toks = np.zeros((n, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=n)
    noise = rng.uniform(size=(n, seq_len)) < 0.05
    for k in range(seq_len):
        nxt = perms[labels, toks[:, k]]
        rand = rng.integers(0, vocab, size=n)
        toks[:, k + 1] = np.where(noise[:, k], rand, nxt)
    return toks, labels


RATIOS = {"type2": [0.9, 0.1]}


def partition(labels: np.ndarray, n_clients: int, kind: str,
              num_classes: int, seed: int) -> list[np.ndarray]:
    """Each client holds ``len(labels) // n_clients`` samples of 2
    classes at 9:1 (Type 2), drawn without replacement from shuffled
    per-class pools that recycle when exhausted."""
    rng = np.random.default_rng(seed)
    by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    for c in range(num_classes):
        rng.shuffle(by_class[c])
    cursors = [0] * num_classes
    spc = len(labels) // n_clients

    def draw(c, k):
        pool, out = by_class[c], []
        while k > 0:
            take = min(k, len(pool) - cursors[c])
            if take <= 0:
                cursors[c] = 0
                rng.shuffle(pool)
                continue
            out.append(pool[cursors[c]:cursors[c] + take])
            cursors[c] += take
            k -= take
        return np.concatenate(out)

    ratios = np.array(RATIOS[kind])
    clients = []
    for _ in range(n_clients):
        cls = rng.choice(num_classes, size=len(ratios), replace=False)
        counts = np.maximum((ratios * spc).astype(int), 1)
        idx = np.concatenate([draw(c, k) for c, k in zip(cls, counts)])
        rng.shuffle(idx)
        clients.append(idx)
    return clients


def prompts(n_batches: int, batch: int, length: int, vocab: int, seed: int,
            device) -> torch.Tensor:
    """(n_batches, batch, length) int64 tokens, uniform over the
    vocabulary, drawn on the device in one call."""
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randint(vocab, (n_batches, batch, length), generator=gen,
                         device=device)
