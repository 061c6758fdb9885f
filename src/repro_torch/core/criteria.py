"""Client selection criteria (paper §IV).

Implements Table I's eleven per-criterion scores, the non-iid degree
``Nid`` (Eq. 2) and its alternatives (L2 / Hellinger / KL distances to
uniform), the overall weighted score (Eq. 6) and the linear cost model
(Eq. 7).

Everything here is plain numpy: this is the FL service provider's
control plane, executed once per task intake / scheduling period, not a
device-scale workload.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

# Canonical criterion order (paper rewrites s_CPU..s_Bhvr as s_1..s_11).
CRITERIA = (
    "cpu", "gpu", "mem", "str", "pow", "bdw", "con",  # resources (7)
    "data_size", "data_dist",                          # data quality (2)
    "model_q", "bhvr",                                 # reputation (2)
)
NUM_CRITERIA = len(CRITERIA)
# Indices of the nine "static" criteria thresholded in Eq. (8d): the paper
# thresholds s_1..s_9 (resources + data quality); reputation criteria are
# dynamic and handled by the scheduling-period pool update instead.
THRESHOLDED = tuple(range(9))

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Resource scores (§IV-A)
# ---------------------------------------------------------------------------

def resource_scores(raw: np.ndarray, minimums: np.ndarray) -> np.ndarray:
    """Convert raw resource readings into (0,1) scores.

    ``raw`` is (n_clients, n_resources); ``minimums`` is the task
    requester's minimal requirement per resource. Per the paper, each
    client's reading is divided by the minimum requirement and the
    resulting column is normalized into (0, 1).
    """
    raw = np.asarray(raw, dtype=np.float64)
    minimums = np.asarray(minimums, dtype=np.float64)
    if np.any(minimums <= 0):
        raise ValueError("minimal requirements must be positive")
    ratio = raw / minimums
    # Normalize each column into (0, 1] by its max (max-normalization keeps
    # the "meets requirement" semantics: ratio>=1 iff requirement met).
    denom = np.maximum(ratio.max(axis=0, keepdims=True), _EPS)
    return ratio / denom


def meets_minimums(raw: np.ndarray, minimums: np.ndarray) -> np.ndarray:
    """Boolean per-client mask: every resource >= the task minimum."""
    raw = np.asarray(raw, dtype=np.float64)
    minimums = np.asarray(minimums, dtype=np.float64)
    return np.all(raw >= minimums, axis=-1)


# ---------------------------------------------------------------------------
# Data distribution score (§IV-B)
# ---------------------------------------------------------------------------

def nid(hist: np.ndarray) -> np.ndarray:
    """Non-iid degree, Eq. (2): (max(h) - min(h)) / sum(h).

    Accepts a single histogram (c,) or a batch (n, c). Empty histograms
    (sum == 0) have Nid defined as 1 (maximally non-iid: no data).
    """
    h = np.asarray(hist, dtype=np.float64)
    total = h.sum(axis=-1)
    spread = h.max(axis=-1) - h.min(axis=-1)
    return np.where(total > 0, spread / np.maximum(total, _EPS), 1.0)


def data_dist_score(hist: np.ndarray) -> np.ndarray:
    """s_DataDist = 1 - Nid(h)."""
    return 1.0 - nid(hist)


def _normalize(hist: np.ndarray) -> np.ndarray:
    h = np.asarray(hist, dtype=np.float64)
    return h / np.maximum(h.sum(axis=-1, keepdims=True), _EPS)


def nid_l2(hist: np.ndarray) -> np.ndarray:
    """Alternative non-iid degree: L2 distance to uniform, scaled to [0,1]."""
    p = _normalize(hist)
    c = p.shape[-1]
    u = 1.0 / c
    d = np.sqrt(((p - u) ** 2).sum(axis=-1))
    # max L2 distance to uniform is sqrt((1-1/c)^2 + (c-1)/c^2) = sqrt(1-1/c)
    return d / np.sqrt(1.0 - 1.0 / c)


def nid_hellinger(hist: np.ndarray) -> np.ndarray:
    """Alternative non-iid degree: Hellinger distance to uniform, rescaled
    so a one-hot histogram maps to 1 (max H to uniform is sqrt(1-1/sqrt(c)))."""
    p = _normalize(hist)
    c = p.shape[-1]
    u = 1.0 / c
    h = np.sqrt(np.clip(1.0 - (np.sqrt(p) * np.sqrt(u)).sum(axis=-1), 0.0, None))
    return np.clip(h / np.sqrt(1.0 - np.sqrt(u)), 0.0, 1.0)


def nid_kl(hist: np.ndarray) -> np.ndarray:
    """Alternative non-iid degree: KL(p || uniform), normalized by log(c)."""
    p = _normalize(hist)
    c = p.shape[-1]
    kl = np.sum(np.where(p > 0, p * np.log(np.maximum(p, _EPS) * c), 0.0), axis=-1)
    return np.clip(kl / np.log(c), 0.0, 1.0)


NID_VARIANTS = {
    "range": nid,
    "l2": nid_l2,
    "hellinger": nid_hellinger,
    "kl": nid_kl,
}


# ---------------------------------------------------------------------------
# Historical model quality (§IV-C) and behavior (§IV-D)
# ---------------------------------------------------------------------------

def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Per-round model quality q_t = sim(w_l, w_g) (cosine)."""
    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na < _EPS or nb < _EPS:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def per_task_average(per_round: Sequence[float]) -> float:
    """Eqs. (3)/(5): average of per-round values over participated rounds."""
    vals = np.asarray(list(per_round), dtype=np.float64)
    if vals.size == 0:
        return 0.0
    return float(vals.mean())


def history_score(per_task: Sequence[float], window: int | None = None) -> float:
    """s_ModelQ / s_Bhvr: average of all (or the ``window`` most recent)
    per-task values."""
    vals = list(per_task)
    if window is not None:
        vals = vals[-window:]
    return per_task_average(vals)


# ---------------------------------------------------------------------------
# Overall score and cost (§IV-E)
# ---------------------------------------------------------------------------

def overall_score(scores: np.ndarray, weights: np.ndarray | None = None) -> np.ndarray:
    """Eq. (6): Score = w · s. ``scores`` is (..., 11)."""
    s = np.asarray(scores, dtype=np.float64)
    if s.shape[-1] != NUM_CRITERIA:
        raise ValueError(f"expected {NUM_CRITERIA} criteria, got {s.shape[-1]}")
    if weights is None:
        weights = np.ones(NUM_CRITERIA)
    w = np.asarray(weights, dtype=np.float64)
    return s @ w


def linear_cost(score: np.ndarray, a: float = 2.0, b: float = 5.0,
                integer: bool = False) -> np.ndarray:
    """Eq. (7): Cost = a·Score + b, a > 0. ``integer=True`` rounds to the
    nearest integer as in the paper's Experiment 1."""
    if a <= 0:
        raise ValueError("a must be > 0")
    c = a * np.asarray(score, dtype=np.float64) + b
    return np.rint(c) if integer else c


# ---------------------------------------------------------------------------
# Client record
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClientProfile:
    """A registered client as the FL service provider sees it (§III)."""

    client_id: int
    scores: np.ndarray                 # (11,) criterion scores in (0,1)
    histogram: np.ndarray              # (c,) label histogram of local data
    cost: float                        # per-round/task price
    available: bool = True
    # reputation bookkeeping (per-task vectors, §IV-C/D)
    model_q_history: list = dataclasses.field(default_factory=list)
    bhvr_history: list = dataclasses.field(default_factory=list)

    @property
    def data_size(self) -> int:
        return int(np.sum(self.histogram))

    @property
    def score(self) -> float:
        return float(overall_score(self.scores))

    def criterion(self, name: str) -> float:
        return float(self.scores[CRITERIA.index(name)])


def build_profiles(
    scores: np.ndarray,
    histograms: np.ndarray,
    costs: np.ndarray,
) -> list[ClientProfile]:
    """Vector inputs -> list of ClientProfile."""
    n = scores.shape[0]
    if histograms.shape[0] != n or np.shape(costs)[0] != n:
        raise ValueError("mismatched client counts")
    return [
        ClientProfile(
            client_id=i,
            scores=np.asarray(scores[i], dtype=np.float64),
            histogram=np.asarray(histograms[i], dtype=np.float64),
            cost=float(costs[i]),
        )
        for i in range(n)
    ]


def random_histograms(n_clients: int, n_classes: int,
                      rng: np.random.Generator,
                      lo: int = 10, hi: int = 200) -> np.ndarray:
    """Vectorized non-iid histogram sampler: per client a uniform label
    count k ~ U{1..c}, k distinct labels, counts ~ U{lo..hi-1}. O(n·c)
    array ops — no per-client Python loop, so 100k+ pools build in
    milliseconds (used by ``ClientPoolState.random``)."""
    perm = rng.random((n_clients, n_classes)).argsort(axis=1)
    k = rng.integers(1, n_classes + 1, size=n_clients)
    on = np.arange(n_classes) < k[:, None]
    vals = rng.integers(lo, hi, size=(n_clients, n_classes)).astype(np.float64)
    hists = np.zeros((n_clients, n_classes))
    np.put_along_axis(hists, perm, np.where(on, vals, 0.0), axis=1)
    return hists


def random_profiles(
    n_clients: int,
    n_classes: int,
    rng: np.random.Generator,
    cost_a: float = 2.0,
    cost_b: float = 5.0,
    integer_cost: bool = True,
) -> list[ClientProfile]:
    """Virtual clients with random criterion scores (paper §VIII-A) and
    random non-iid histograms; cost from Eq. (7)."""
    scores = rng.uniform(0.0, 1.0, size=(n_clients, NUM_CRITERIA))
    # histograms: random number of labels per client, random sizes
    hists = np.zeros((n_clients, n_classes))
    for i in range(n_clients):
        k = int(rng.integers(1, n_classes + 1))
        labels = rng.choice(n_classes, size=k, replace=False)
        hists[i, labels] = rng.integers(10, 200, size=k)
    # data-driven criteria overwrite the random placeholders
    sizes = hists.sum(axis=1)
    scores[:, CRITERIA.index("data_size")] = sizes / sizes.max()
    scores[:, CRITERIA.index("data_dist")] = data_dist_score(hists)
    total = overall_score(scores)
    costs = linear_cost(total, cost_a, cost_b, integer=integer_cost)
    return build_profiles(scores, hists, costs)
