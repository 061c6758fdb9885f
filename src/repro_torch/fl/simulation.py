"""End-to-end FL simulation: glues the core service lifecycle
(selection/scheduling, ``core.lifecycle``) to real PyTorch training
(fl.round) over partitioned synthetic data — the machinery behind the
paper's Figs. 5/6 experiments.

:class:`DeviceFLSim` is the device-resident data plane: the partitioned
dataset is staged on the device once (fl.device_data.DeviceDataset) and
``run_rounds`` drives S rounds per call through the chunk function
(fl.round.make_fl_rounds_scan) with on-device batch gather, dropout
masks, and the fused aggregation + quality kernel. It is an
``AsyncTrainer``: ``dispatch_rounds`` enqueues the chunk's work on the
device and returns tensors the host has not waited for, ``collect``
blocks.

Batch positions and dropout come from the same slot-keyed counter-based
stream as the JAX package's (:mod:`repro_torch.random`), so with the
same seed and parameters both see identical schedules, masks and
batches.

Entry points run on the card: ``device=None`` means ``"cuda"``, and
without CUDA they raise. Pass ``device="cpu"`` to run on the CPU.

Not ported yet (ROADMAP.md Queue 1): the host-loop trainer
``FLClassificationSim``, fault plans, compression, server optimizers,
the mesh-sharded scan, device placement and trainer checkpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import (ClientPoolState, FLServiceProvider, TaskRequest,
                              lifecycle)
from repro_torch.core.criteria import (NUM_CRITERIA, data_dist_score,
                                       linear_cost, overall_score)
from repro_torch.data.synthetic import ClassificationData
from repro_torch.fl import device_data
from repro_torch.fl.partition import client_histograms
from repro_torch.fl.round import make_fl_rounds_scan
from repro_torch.models import cnn


@dataclasses.dataclass
class SimConfig:
    batch_size: int = 16
    local_steps: int = 2
    local_lr: float = 0.1
    server_lr: float = 1.0
    dropout_rate: float = 0.05        # paper: 5% of clients drop per period
    eval_every: int = 5
    seed: int = 0


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for but absent:
    the port never drifts onto the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    return dev


def pool_from_partition(labels, parts, num_classes,
                        seed: int = 0) -> ClientPoolState:
    """Array-native client pool whose data criteria come from the real
    partition and whose resource criteria are random (paper §VIII-A)."""
    rng = np.random.default_rng(seed)
    hists = client_histograms(labels, parts, num_classes)
    n = len(parts)
    scores = rng.uniform(0.3, 1.0, size=(n, NUM_CRITERIA))
    H = np.stack([hists[i] for i in range(n)])
    sizes = H.sum(axis=1)
    scores[:, 7] = sizes / max(sizes.max(), 1)
    scores[:, 8] = data_dist_score(H)
    costs = linear_cost(overall_score(scores), 2.0, 5.0, integer=True)
    return ClientPoolState(np.arange(n, dtype=np.int64), scores, H, costs)


class _EvalCache:
    """Eval/history machinery: the test set is cached on the device once
    (evaluate() only ships sampled indices), and per-round metrics and
    history bookkeeping live in one place."""

    def _init_eval(self, model_cfg: cnn.CNNConfig, test: ClassificationData,
                   sim: SimConfig):
        self.sim = sim
        self._test_images = torch.as_tensor(np.asarray(test.images),
                                            device=self.device)
        self._test_labels = torch.as_tensor(np.asarray(test.labels, np.int64),
                                            device=self.device)
        self._eval_rng = np.random.default_rng(sim.seed)
        self.history: list[dict] = []

    @torch.no_grad()
    def _enqueue_eval(self, params, n: int = 1024):
        """Enqueue an accuracy evaluation of ``params`` on the cached
        test set; returns a device scalar the host has not waited for.
        Consumes one draw from the eval rng stream, so enqueue order
        must match record order."""
        m = len(self._test_labels)
        idx = torch.as_tensor(self._eval_rng.choice(m, size=min(n, m),
                                                    replace=False),
                              device=self.device)
        logits = cnn.forward(self.cfg, params, self._test_images[idx])
        return (logits.argmax(-1) == self._test_labels[idx]).to(
            torch.float32).mean()

    def evaluate(self, n: int = 1024) -> float:
        """Accuracy of the current params on a sampled test subset
        (blocking)."""
        return float(self._enqueue_eval(self.params, n))

    def _record(self, rnd: int, loss, accuracy=None) -> dict:
        """Append round ``rnd`` to ``history``. Eval rounds take their
        accuracy from ``accuracy`` when the caller already enqueued the
        evaluation (the async collect path), else evaluate now."""
        metrics = {"round": rnd, "loss": float(loss)}
        if rnd % self.sim.eval_every == 0:
            metrics["accuracy"] = (self.evaluate() if accuracy is None
                                   else float(accuracy))
        self.history.append(metrics)
        return metrics


class DeviceFLSim(_EvalCache):
    """Device-resident trainer: staged dataset + chunk function.

    Implements the ``core.lifecycle.AsyncTrainer`` protocol — the
    chunked ``run_rounds`` (driven with ``task.round_chunk > 1``) splits
    into ``dispatch_rounds`` (enqueue only) and ``collect`` (block +
    bookkeeping).

    Subsets sized n±δ share one static client axis K per call (padding
    is semantics-free thanks to slot-keyed randomness), and a chunk may
    be split into several calls: a small DP picks the segmentation
    minimizing padded-slot waste plus a fixed per-call cost, so e.g. a
    [5,5,5,11]-sized chunk trains as [5,5,5]+[11] rather than
    all-padded-to-11. ``pad_subset_to`` caps K.

    Eval rounds (``rnd % eval_every == 0``) force a split so the call
    ends exactly at the eval round — accuracy is always measured with
    that round's params.

    ``device=None`` runs on ``cuda`` and raises without it. Parameters
    are drawn from ``torch.Generator().manual_seed(sim.seed)``; to start
    from the reference's parameters, assign
    ``cnn.params_from_jax(...)`` (moved to the trainer's ``device``) to
    ``params``.
    """

    # estimated fixed cost of one extra call, in units of one padded
    # client-slot-round of training compute (sets how eagerly the
    # segmentation DP splits a chunk to avoid padding waste)
    DISPATCH_COST = 4.0

    def __init__(self, model_cfg: cnn.CNNConfig, data: ClassificationData,
                 parts: list[np.ndarray], test: ClassificationData,
                 sim: SimConfig = SimConfig(),
                 pad_subset_to: int | None = None, fault_plan=None,
                 compression: str | None = None,
                 server_opt: str | None = None, mesh=None, device=None):
        if fault_plan is not None:
            raise NotImplementedError("fault plans are not ported yet: "
                                      "ROADMAP.md Queue 1 item 5")
        if mesh is not None:
            raise NotImplementedError("the mesh-sharded round scan is not "
                                      "ported yet: ROADMAP.md Queue 1 item 8")
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.pad_subset_to = pad_subset_to
        self.base_key = trandom.prng_key(sim.seed, self.device)
        self.params = cnn.init_params(
            model_cfg, torch.Generator().manual_seed(sim.seed), self.device)
        self.data = device_data.DeviceDataset.stage(data, parts, self.device)
        self.chunk_fn = make_fl_rounds_scan(
            lambda p, b: cnn.loss_fn(model_cfg, p, b),
            local_lr=sim.local_lr, local_steps=sim.local_steps,
            batch_size=sim.batch_size, server_lr=sim.server_lr,
            dropout_rate=sim.dropout_rate, compression=compression,
            server_opt=server_opt)
        self._init_eval(model_cfg, test, sim)

    def _k_pad(self, k: int) -> int:
        """Padded client axis for a segment whose largest subset has k
        clients: next multiple of 2 (fewer distinct shapes), capped at
        pad_subset_to but never below k."""
        pad = -(-k // 2) * 2
        if self.pad_subset_to is not None:
            pad = min(pad, self.pad_subset_to)
        return max(pad, k)

    def _segment(self, sizes: list[int]) -> list[int]:
        """Optimal consecutive segmentation of one chunk (DP): minimize
        Σ over segments of [DISPATCH_COST + Σ_t (K_seg − k_t)] where
        K_seg pads the segment's max size. Returns segment lengths."""
        n = len(sizes)
        best = [0.0] + [float("inf")] * n       # best[i]: cost of sizes[:i]
        cut = [0] * (n + 1)
        for i in range(1, n + 1):
            kmax = 0
            waste = 0.0
            for j in range(i - 1, -1, -1):      # segment sizes[j:i]
                if sizes[j] > kmax:              # pad grew: recompute
                    kmax = sizes[j]
                    kp = self._k_pad(kmax)
                    waste = float(sum(kp - s for s in sizes[j:i]))
                else:
                    waste += self._k_pad(kmax) - sizes[j]
                cost = best[j] + self.DISPATCH_COST + waste
                if cost < best[i]:
                    best[i] = cost
                    cut[i] = j
        lengths: list[int] = []
        i = n
        while i > 0:
            lengths.append(i - cut[i])
            i = cut[i]
        return lengths[::-1]

    # -- async trainer protocol (core.lifecycle.AsyncTrainer) ----------------
    def dispatch_rounds(self, start_round: int,
                        subsets: Sequence[Sequence[int]],
                        weights: Sequence[np.ndarray],
                        arrivals: Sequence[np.ndarray] | None = None
                        ) -> list[tuple]:
        """Enqueue ``len(subsets)`` consecutive rounds without waiting
        for the device: every segment's chunk call (and, for segments
        ending at an eval round, its accuracy evaluation) is issued
        back-to-back. Chunks are split after every eval round and per
        the padding-vs-call-cost DP (``_segment``); ``run_rounds`` is
        ``collect`` of this."""
        if arrivals is not None:
            raise NotImplementedError("fault-mode arrival masks are not "
                                      "ported yet: ROADMAP.md Queue 1 item 5")
        handles = []
        seg_start = 0
        for e in range(len(subsets)):
            if (start_round + e) % self.sim.eval_every == 0 \
                    or e == len(subsets) - 1:
                block = subsets[seg_start:e + 1]
                r = start_round + seg_start
                for length in self._segment([len(s) for s in block]):
                    handles.append(self._enqueue_segment(
                        r, subsets[seg_start:seg_start + length],
                        weights[seg_start:seg_start + length]))
                    r += length
                    seg_start += length
        return handles

    def collect(self, handles: list[tuple]) -> list[tuple]:
        """Materialize a ``dispatch_rounds`` handle: block on each
        segment's tensors in dispatch order and emit the per-round
        ``(returned, q_values, metrics)`` tuples + history records."""
        out = []
        for start_round, subsets, info, eval_acc in handles:
            masks = info["masks"].cpu().numpy()
            qs = info["q_values"].cpu().numpy()
            losses = info["mean_loss"].cpu().numpy()
            for t, subset in enumerate(subsets):
                k = len(subset)
                # only a segment's final round can be an eval round (the
                # split above guarantees it), so eval_acc is unambiguous
                metrics = self._record(start_round + t, losses[t],
                                       accuracy=eval_acc)
                out.append((masks[t, :k] > 0, qs[t, :k], metrics))
        return out

    def run_rounds(self, start_round: int, subsets: Sequence[Sequence[int]],
                   weights: Sequence[np.ndarray],
                   arrivals: Sequence[np.ndarray] | None = None
                   ) -> list[tuple]:
        """Blocking chunk execution: enqueue everything, then collect."""
        return self.collect(self.dispatch_rounds(start_round, subsets,
                                                 weights, arrivals))

    def _enqueue_segment(self, start_round: int,
                         subsets: Sequence[Sequence[int]],
                         weights: Sequence[np.ndarray]) -> tuple:
        """One chunk call for ``len(subsets)`` consecutive rounds;
        returns ``(start_round, subsets, info, eval_acc)`` with ``info``
        (and ``eval_acc``, when the segment ends at an eval round) still
        on the device. The eval is enqueued here, against this segment's
        output params."""
        S = len(subsets)
        K = self._k_pad(max(len(s) for s in subsets))
        rows = np.zeros((S, K), dtype=np.int64)
        w = np.zeros((S, K), dtype=np.float32)
        active = np.zeros((S, K), dtype=np.float32)
        for t, (subset, wt) in enumerate(zip(subsets, weights)):
            k = len(subset)
            rows[t, :k] = np.asarray(subset, dtype=np.int64)
            w[t, :k] = np.asarray(wt, dtype=np.float32)
            active[t, :k] = 1.0
        dev = self.device
        schedule = {"rows": torch.as_tensor(rows, device=dev),
                    "weights": torch.as_tensor(w, device=dev),
                    "active": torch.as_tensor(active, device=dev),
                    "round_ids": torch.arange(start_round, start_round + S,
                                              dtype=torch.int64, device=dev)}
        self.params, info = self.chunk_fn(self.params, self.data, schedule,
                                          self.base_key)
        eval_acc = None
        if (start_round + S - 1) % self.sim.eval_every == 0:
            eval_acc = self._enqueue_eval(self.params)
        return start_round, list(subsets), info, eval_acc


def run_fl_experiment(kind: str, noniid: str, n_clients: int = 100,
                      rounds: int = 30, scheduler: str = "mkp",
                      n_train: int = 6000, n_test: int = 1500,
                      subset_size: int = 10, subset_delta: int = 3,
                      sim: SimConfig = SimConfig(),
                      seed: int = 0, data_plane: str = "device",
                      round_chunk: int = 8,
                      budget: float = 1e9, n_star: int | None = None,
                      selection_policy: str | None = None,
                      scheduling_policy: str | None = None,
                      fault_plan=None, overschedule_factor: float = 1.0,
                      quorum_frac: float = 0.0,
                      collect_deadline: float = 0.0,
                      compression: str | None = None,
                      server_opt: str | None = None,
                      device=None) -> dict:
    """One learning-curve run (paper Figs. 5/6): returns history + config.

    ``data_plane="device"`` (the default, and the only plane ported)
    stages the dataset on the device and runs ``round_chunk`` rounds per
    call through the chunk function; the host-loop plane (``"host"``) is
    not ported yet and raises.

    ``selection_policy`` / ``scheduling_policy`` pick registered
    ``core.policy`` strategies; unset (``None``), the legacy
    ``scheduler`` alias decides (``"random"`` -> ``random_partition``).
    ``n_star`` defaults to ``n_clients`` when the budget is
    unconstrained (the paper's full-pool setup) and to 1 otherwise.

    ``device=None`` runs on ``cuda`` and raises without it.
    """
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.fl.partition import partition_labels

    if data_plane == "host":
        raise NotImplementedError("the host-loop data plane is not ported "
                                  "yet: ROADMAP.md Queue 1 item 3; use "
                                  "data_plane='device'")
    if data_plane != "device":
        raise ValueError(f"unknown data_plane {data_plane!r}")
    device = resolve_device(device)
    # one generation pass -> shared class prototypes; split train/test
    full = make_classification_data(kind, n_train + n_test, seed=seed)
    data = full.subset(np.arange(n_train))
    test = full.subset(np.arange(n_train, n_train + n_test))
    parts = partition_labels(data.labels, n_clients, noniid,
                             data.num_classes, seed=seed)
    pool = pool_from_partition(data.labels, parts, data.num_classes,
                               seed=seed)
    provider = FLServiceProvider(pool)
    model_cfg = cnn.MNIST_CNN if kind == "mnist" else cnn.CIFAR_CNN
    simul = DeviceFLSim(model_cfg, data, parts, test, sim,
                        pad_subset_to=subset_size + subset_delta,
                        fault_plan=fault_plan, compression=compression,
                        server_opt=server_opt, device=device)

    if n_star is None:
        n_star = n_clients if budget >= 1e9 else 1
    task = TaskRequest(budget=budget, n_star=n_star, subset_size=subset_size,
                       subset_delta=subset_delta, x_star=3, max_periods=10_000,
                       scheduler=scheduler, seed=seed,
                       round_chunk=round_chunk, max_rounds=rounds,
                       selection_policy=selection_policy,
                       scheduling_policy=scheduling_policy,
                       overschedule_factor=overschedule_factor,
                       quorum_frac=quorum_frac,
                       collect_deadline=collect_deadline,
                       compression=compression)
    state = lifecycle.submit(provider, task)
    state, _ = lifecycle.drain(provider, state, simul,
                               stop_fn=lambda m: m["round"] + 1 >= rounds)
    result = lifecycle.as_run_result(state)
    return {"history": simul.history, "service": result, "state": state,
            "final_accuracy": simul.evaluate(), "scheduler": scheduler,
            "noniid": noniid, "kind": kind}
