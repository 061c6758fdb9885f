"""Non-iid client data partitioners (paper §VIII-A).

Type 1: each client holds one label.
Type 2: two labels, 9:1.
Type 3: mostly three labels 5:4:1; a few clients 5:1 or 4:1.
Plus 'iid' and Dirichlet partitions for extra experiments.
"""
from __future__ import annotations

import numpy as np


def _ratios(kind: str, rng) -> np.ndarray:
    if kind == "type1":
        return np.array([1.0])
    if kind == "type2":
        return np.array([0.9, 0.1])
    if kind == "type3":
        if rng.uniform() < 0.1:
            r = rng.choice([5.0, 4.0])
            return np.array([r, 1.0]) / (r + 1.0)
        return np.array([0.5, 0.4, 0.1])
    raise ValueError(kind)


def partition_labels(labels: np.ndarray, n_clients: int, kind: str,
                     num_classes: int, seed: int = 0,
                     samples_per_client: int | None = None) -> list[np.ndarray]:
    """Assign sample indices to clients per the paper's non-iid types.

    Returns a list of index arrays (one per client). Sampling is done
    with replacement-free draws from per-class pools; pools recycle if
    exhausted (keeps client sizes equal, matching the paper's setup).
    """
    rng = np.random.default_rng(seed)
    by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    for c in range(num_classes):
        rng.shuffle(by_class[c])
    cursors = [0] * num_classes
    spc = samples_per_client or len(labels) // n_clients

    def draw(c, k):
        nonlocal cursors
        pool = by_class[c]
        if len(pool) == 0:
            return np.array([], dtype=np.int64)
        out = []
        while k > 0:
            take = min(k, len(pool) - cursors[c])
            if take <= 0:
                cursors[c] = 0   # recycle
                rng.shuffle(pool)
                continue
            out.append(pool[cursors[c]:cursors[c] + take])
            cursors[c] += take
            k -= take
        return np.concatenate(out)

    clients = []
    for _ in range(n_clients):
        if kind == "iid":
            per = np.maximum(spc // num_classes, 1)
            idx = np.concatenate([draw(c, per) for c in range(num_classes)])
        else:
            ratios = _ratios(kind, rng)
            cls = rng.choice(num_classes, size=len(ratios), replace=False)
            counts = np.maximum((ratios * spc).astype(int), 1)
            idx = np.concatenate([draw(c, k) for c, k in zip(cls, counts)])
        rng.shuffle(idx)
        clients.append(idx)
    return clients


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        num_classes: int, seed: int = 0) -> list[np.ndarray]:
    """Standard Dirichlet(alpha) non-iid partition (beyond-paper extra)."""
    rng = np.random.default_rng(seed)
    props = rng.dirichlet([alpha] * n_clients, size=num_classes)  # (C, K)
    clients = [[] for _ in range(n_clients)]
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        splits = (np.cumsum(props[c])[:-1] * len(idx)).astype(int)
        for k, part in enumerate(np.split(idx, splits)):
            clients[k].append(part)
    return [np.concatenate(p) if p else np.array([], np.int64)
            for p in clients]


def client_histograms(labels: np.ndarray, parts: list[np.ndarray],
                      num_classes: int) -> dict[int, np.ndarray]:
    return {i: np.bincount(labels[p], minlength=num_classes).astype(np.float64)
            for i, p in enumerate(parts)}


def dense_index_pools(parts: list[np.ndarray],
                      cap: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Ragged per-client sample-index lists -> dense device-friendly form.

    Returns ``(pools, sizes)`` where ``pools`` is ``(n_clients, cap)``
    int32 (each row the client's sample indices, padded by cycling the
    row's own indices so every slot is a valid sample of that client)
    and ``sizes`` is ``(n_clients,)`` int32 true pool sizes. This is the
    staging format of the device-resident data plane (fl.device_data):
    batch sampling draws positions in ``[0, sizes[k])`` so the padding
    never biases the draw.
    """
    n = len(parts)
    cap = cap or max((len(p) for p in parts), default=1)
    cap = max(cap, 1)
    pools = np.zeros((n, cap), dtype=np.int32)
    sizes = np.zeros(n, dtype=np.int32)
    for k, idx in enumerate(parts):
        m = len(idx)
        sizes[k] = m
        if m == 0:
            continue
        if m > cap:
            raise ValueError(f"client {k} has {m} samples > cap={cap}")
        reps = -(-cap // m)                    # ceil-div: cycle the row
        pools[k] = np.tile(np.asarray(idx, dtype=np.int32), reps)[:cap]
    return pools, sizes
