"""End-to-end FL simulation: glues the core service lifecycle
(selection/scheduling, ``core.lifecycle``) to real PyTorch training
(fl.round) over partitioned synthetic data — the machinery behind the
paper's Figs. 5/6 experiments. Two trainers implement the lifecycle's
``Trainer`` protocol:

- :class:`FLClassificationSim` is the host-loop data plane (the
  reference's default): every round assembles the client batches on the
  host (numpy indexing per client), ships them to the device and runs
  one ``fl.round.make_fl_round`` call. A plain sync ``Trainer``.
- :class:`DeviceFLSim` is the device-resident data plane: the
  partitioned dataset is staged on the device once
  (fl.device_data.DeviceDataset) and ``run_rounds`` drives S rounds per
  call through the chunk function (fl.round.make_fl_rounds_scan) with
  on-device batch gather, dropout masks, and the fused aggregation +
  quality kernel, optionally from compressed client updates
  (``compression``) and with a FedAdam/FedYogi server step
  (``server_opt``). An ``AsyncTrainer``: ``dispatch_rounds`` enqueues
  the chunk's work on the device and returns tensors the host has not
  waited for, ``collect`` blocks.

Both carry an optional :class:`repro_torch.core.faults.FaultPlan`
(``fault_plan=``), which switches the lifecycle into its fault mode;
they then take each round's arrival mask and mask the clients that did
not report out of the aggregate.

Batch positions and dropout come from the same slot-keyed counter-based
stream as the JAX package's (:mod:`repro_torch.random`), so with the
same seed and parameters both planes, and both packages, see identical
schedules, masks and batches.

Entry points run on the card: ``device=None`` means ``"cuda"``, and
without CUDA they raise. Pass ``device="cpu"`` to run on the CPU.

Placement: ``DeviceFLSim(mesh=...)`` splits each round's clients over a
mesh's data shards (fl.round.make_fl_rounds_scan_sharded), and
``DeviceFLSim.place_on(i)`` is the ``ServiceScheduler``'s placement hook,
which moves a trainer's state to ``cuda:i``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import optim
from repro_torch import random as trandom
from repro_torch.core import (ClientPoolState, FLServiceProvider, TaskRequest,
                              lifecycle)
from repro_torch.core.criteria import (NUM_CRITERIA, ClientProfile,
                                       data_dist_score, linear_cost,
                                       overall_score)
from repro_torch.data.synthetic import ClassificationData
from repro_torch.device import conv_numerics, resolve_device
from repro_torch.fl import device_data
from repro_torch.fl.partition import client_histograms
from repro_torch.fl.round import (make_fl_round, make_fl_rounds_scan,
                                  make_fl_rounds_scan_sharded, shard_devices)
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


def profiles_from_partition(labels, parts, num_classes,
                            seed: int = 0) -> list[ClientProfile]:
    """Dataclass adapter over :func:`pool_from_partition` (same draws)."""
    return pool_from_partition(labels, parts, num_classes, seed).to_profiles()


def _to(tree, device):
    """Every tensor of nested dicts, lists and staged datasets moved to
    ``device``; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return device_data.to_device(tree, device)


class _ReferenceKeys:
    """Read-only view of an exported state under the port's flat names:
    ``view["params/conv1.w"]`` is ``arrays["params/conv1/w"]``."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def __getitem__(self, key: str):
        return self.arrays[key.replace(".", "/")]


class _EvalCache:
    """Eval/history machinery: the test set is cached on the device once
    (evaluate() only ships sampled indices), and per-round metrics and
    history bookkeeping live in one place."""

    def _init_eval(self, model_cfg: cnn.CNNConfig, test: ClassificationData,
                   sim: SimConfig, impl: str = "reference"):
        self.sim = sim
        self._eval_impl = impl
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
        with conv_numerics():
            logits = cnn.forward(self.cfg, params, self._test_images[idx],
                                 impl=self._eval_impl)
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


class FLClassificationSim(_EvalCache):
    """Federated CNN training over a partitioned synthetic dataset: the
    host-loop data plane. Each round draws its batch positions and
    dropout from the slot-keyed stream on the device, copies the draws
    to the host, assembles the client batches there with the reference's
    numpy index arithmetic, ships them to the device and runs one
    ``make_fl_round`` call.

    Implements the ``core.lifecycle.Trainer`` protocol: ``run_rounds``
    runs a chunk one round at a time (so chunking changes nothing but
    the grouping of trainer calls); ``run_fl_experiment`` drives it with
    ``round_chunk = 1``. ``device=None`` runs on ``cuda`` and raises
    without it; parameters are drawn as :class:`DeviceFLSim` draws them.
    """

    # the lifecycle's fault mode may pass per-round arrival masks
    accepts_arrivals = True

    def __init__(self, model_cfg: cnn.CNNConfig, data: ClassificationData,
                 parts: list[np.ndarray], test: ClassificationData,
                 sim: SimConfig = SimConfig(), fault_plan=None, device=None):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.data = data
        self.parts = parts
        self.test = test
        self.fault_plan = fault_plan
        self.base_key = trandom.prng_key(sim.seed, self.device)
        self.params = cnn.init_params(
            model_cfg, torch.Generator().manual_seed(sim.seed), self.device)
        self.round_fn = make_fl_round(
            lambda p, b: cnn.loss_fn(model_cfg, p, b),
            local_lr=sim.local_lr, local_steps=sim.local_steps,
            server_lr=sim.server_lr)
        self._init_eval(model_cfg, test, sim)

    # -- batching -----------------------------------------------------------
    def _round_draws(self, rnd: int, K: int):
        """The round's slot-keyed draws: ``mask_u`` (K,) on the device,
        ``pos_u`` (K, E, b) f32 copied to the host."""
        mask_u, pos_u = device_data.sample_positions(
            self.base_key, rnd, K, self.sim.local_steps, self.sim.batch_size)
        return mask_u, pos_u.cpu().numpy()

    def _client_batches(self, subset, pos_u):
        E, b = self.sim.local_steps, self.sim.batch_size
        imgs, labs = [], []
        for i, cid in enumerate(subset):
            idx = self.parts[cid]
            pos = np.minimum((pos_u[i] * len(idx)).astype(np.int64),
                             len(idx) - 1)
            take = idx[pos.reshape(-1)]
            imgs.append(self.data.images[take].reshape(
                E, b, *self.data.images.shape[1:]))
            labs.append(self.data.labels[take].reshape(E, b))
        return {"images": torch.as_tensor(np.stack(imgs), device=self.device),
                "labels": torch.as_tensor(np.stack(labs).astype(np.int64),
                                          device=self.device)}

    # -- core.lifecycle.Trainer protocol -------------------------------------
    def __call__(self, rnd: int, subset, weights, arrival=None) -> tuple:
        K = len(subset)
        dev = self.device
        mask_u, pos_u = self._round_draws(rnd, K)
        arr = None if arrival is None else torch.as_tensor(
            np.asarray(arrival, dtype=np.float32), device=dev)
        mask = device_data.dropout_mask(
            mask_u, torch.ones(K, device=dev), self.sim.dropout_rate,
            arrival=arr)
        batches = self._client_batches(subset, pos_u)
        self.params, info = self.round_fn(
            self.params, batches,
            torch.as_tensor(np.asarray(weights, dtype=np.float32), device=dev),
            mask)
        metrics = self._record(rnd, info["mean_loss"])
        return (mask.cpu().numpy() > 0, info["q_values"].cpu().numpy(),
                metrics)

    def run_rounds(self, start_round: int, subsets: Sequence[Sequence[int]],
                   weights: Sequence[np.ndarray],
                   arrivals: Sequence[np.ndarray] | None = None
                   ) -> list[tuple]:
        """Sequential host loop over the chunk (one round call a round)."""
        return [self(start_round + j, subset, np.asarray(w),
                     arrival=None if arrivals is None else arrivals[j])
                for j, (subset, w) in enumerate(zip(subsets, weights))]

    @property
    def trainer(self):
        """The object itself (callable per round and a ``Trainer``)."""
        return self


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

    ``compression`` is the ``TaskRequest`` spec string
    (fl.compression); ``server_opt`` names a :mod:`repro_torch.optim`
    server optimizer (``"fedadam"``, ``"fedyogi"``) applied to the
    pseudo-gradient with lr = ``sim.server_lr``; its state
    (``opt_state``) lives on the trainer's device and rides every chunk.
    Both default off, and then the rounds are those of the uncompressed
    plane.

    ``impl`` is the CNN's lowering (models.cnn: ``"auto"`` is cuDNN on
    the card and im2col on the CPU); ``fused_quality=False`` takes the
    two-pass aggregate and quality path of fl.round. ``fault_plan``
    attaches a :class:`repro_torch.core.faults.FaultPlan`; under an
    active plan the lifecycle hands ``dispatch_rounds`` the rounds'
    arrival masks, which ride the schedule as ``"arrival"``.

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`, e.g.
    ``make_host_mesh()``) swaps in the client-sharded chunk function:
    each round's client axis splits over the mesh's data shards, whose
    weighted sums are added on the mesh's first device, which is then
    the trainer's ``device`` (leave ``device`` at ``None``). The static
    K is rounded up to a multiple of the shard count, and the dataset is
    staged once on each distinct mesh device. Out of the sharded plane's
    scope, as in the reference: compression, server optimizers,
    simulated dropout.

    ``place_on(i)`` moves the trainer to ``cuda:i`` (the
    ``ServiceScheduler``'s placement hook).

    ``device=None`` runs on ``cuda`` and raises without it. Parameters
    are drawn from ``torch.Generator().manual_seed(sim.seed)``; to start
    from the reference's parameters, assign
    ``cnn.params_from_jax(...)`` (moved to the trainer's ``device``) to
    ``params`` before the first round (the optimizer state is zeros of
    the same shapes, so it need not be rebuilt).
    """

    # estimated fixed cost of one extra call, in units of one padded
    # client-slot-round of training compute (sets how eagerly the
    # segmentation DP splits a chunk to avoid padding waste)
    DISPATCH_COST = 4.0

    # the lifecycle's fault mode may pass per-round arrival masks
    accepts_arrivals = True

    # class-level defaults, so subclasses with their own __init__
    # (TransformerFLSim) stay on the unsharded plane: no mesh, one shard
    _mesh = None
    _shards = 1

    # what place_on moves (a subclass adds its own device state)
    _PLACED = ("params", "opt_state", "data", "base_key", "_test_images",
               "_test_labels")

    def __init__(self, model_cfg: cnn.CNNConfig, data: ClassificationData,
                 parts: list[np.ndarray], test: ClassificationData,
                 sim: SimConfig = SimConfig(), impl: str = "auto",
                 pad_subset_to: int | None = None,
                 fused_quality: bool = True, fault_plan=None,
                 compression: str | None = None,
                 server_opt: str | None = None, mesh=None, device=None):
        if mesh is not None:
            if compression is not None or server_opt is not None:
                raise ValueError("mesh-sharded DeviceFLSim supports the "
                                 "uncompressed plain-SGD plane only")
            if sim.dropout_rate:
                raise ValueError("mesh-sharded DeviceFLSim does not "
                                 "simulate client dropout (the all-"
                                 "dropped fallback is global across K); "
                                 "set sim.dropout_rate = 0.0")
            if device is not None:
                raise ValueError("mesh-sharded DeviceFLSim runs on the "
                                 "mesh's first device: leave device=None")
            devs = shard_devices(mesh)
            device = devs[0]
            self._mesh = mesh
            self._shards = len(devs)
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.pad_subset_to = pad_subset_to
        self.fault_plan = fault_plan
        self.base_key = trandom.prng_key(sim.seed, self.device)
        self.params = cnn.init_params(
            model_cfg, torch.Generator().manual_seed(sim.seed), self.device)
        self._server_opt = None if server_opt is None \
            else optim.make(server_opt, sim.server_lr)
        self.opt_state = None if self._server_opt is None \
            else self._server_opt.init(self.params)
        loss = lambda p, b: cnn.loss_fn(model_cfg, p, b, impl=impl)
        if mesh is None:
            self.data = device_data.DeviceDataset.stage(data, parts,
                                                        self.device)
            self.chunk_fn = make_fl_rounds_scan(
                loss, local_lr=sim.local_lr, local_steps=sim.local_steps,
                batch_size=sim.batch_size, server_lr=sim.server_lr,
                dropout_rate=sim.dropout_rate, fused_quality=fused_quality,
                compression=compression, server_opt=self._server_opt)
        else:
            # one copy a distinct device: a mesh that repeats a device
            # shares it
            self.data = {d: device_data.DeviceDataset.stage(data, parts, d)
                         for d in dict.fromkeys(shard_devices(mesh))}
            self.chunk_fn = make_fl_rounds_scan_sharded(
                loss, local_lr=sim.local_lr, local_steps=sim.local_steps,
                batch_size=sim.batch_size, server_lr=sim.server_lr,
                mesh=mesh)
        self._init_eval(model_cfg, test, sim, impl=impl)

    def _k_pad(self, k: int) -> int:
        """Padded client axis for a segment whose largest subset has k
        clients: next multiple of 2 (fewer distinct shapes), capped at
        pad_subset_to but never below k; then rounded up to a multiple
        of the shard count (each shard takes K/n client slots; the
        reference rounds only for more than 2 shards, and so refuses
        an odd cap on 2)."""
        pad = -(-k // 2) * 2
        if self.pad_subset_to is not None:
            pad = min(pad, self.pad_subset_to)
        pad = max(pad, k)
        return -(-pad // self._shards) * self._shards

    def place_on(self, device_index: int) -> None:
        """``ServiceScheduler`` placement hook: move the server state,
        the optimizer state, the staged dataset, ``base_key`` and the
        eval cache to ``cuda:<device_index>``, where every later chunk
        then runs. A no-op in mesh-sharded mode (the sharded scan already
        spans its devices). A CPU trainer has one device, index 0;
        nothing falls back to another device."""
        if self._mesh is not None:
            return
        if self.device.type != "cuda":
            if device_index != 0:
                raise ValueError(f"a {self.device.type} trainer has one "
                                 f"device (index 0), not {device_index}")
            return
        if not 0 <= device_index < torch.cuda.device_count():
            raise ValueError(f"device index {device_index}: "
                             f"{torch.cuda.device_count()} CUDA device(s)")
        dev = torch.device("cuda", device_index)
        for name in self._PLACED:
            setattr(self, name, _to(getattr(self, name), dev))
        self.device = dev

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
        ``collect`` of this. ``arrivals`` (the lifecycle's fault mode)
        holds each round's (k,) arrival mask."""
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
                        weights[seg_start:seg_start + length],
                        None if arrivals is None
                        else arrivals[seg_start:seg_start + length]))
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
            wire = info["bytes"].cpu().numpy() if "bytes" in info else None
            for t, subset in enumerate(subsets):
                k = len(subset)
                # only a segment's final round can be an eval round (the
                # split above guarantees it), so eval_acc is unambiguous
                metrics = self._record(start_round + t, losses[t],
                                       accuracy=eval_acc)
                if wire is not None:
                    metrics["bytes"] = float(wire[t])
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
                         weights: Sequence[np.ndarray],
                         arrivals: Sequence[np.ndarray] | None = None
                         ) -> tuple:
        """One chunk call for ``len(subsets)`` consecutive rounds;
        returns ``(start_round, subsets, info, eval_acc)`` with ``info``
        (and ``eval_acc``, when the segment ends at an eval round) still
        on the device. The eval is enqueued here, against this segment's
        output params. Only fault-mode segments carry ``"arrival"`` in
        the schedule, so the no-fault rounds are untouched."""
        S = len(subsets)
        K = self._k_pad(max(len(s) for s in subsets))
        rows = np.zeros((S, K), dtype=np.int64)
        w = np.zeros((S, K), dtype=np.float32)
        active = np.zeros((S, K), dtype=np.float32)
        arr = None if arrivals is None \
            else np.zeros((S, K), dtype=np.float32)
        for t, (subset, wt) in enumerate(zip(subsets, weights)):
            k = len(subset)
            rows[t, :k] = np.asarray(subset, dtype=np.int64)
            w[t, :k] = np.asarray(wt, dtype=np.float32)
            active[t, :k] = 1.0
            if arr is not None:
                arr[t, :k] = np.asarray(arrivals[t], dtype=np.float32)
        dev = self.device
        schedule = {"rows": torch.as_tensor(rows, device=dev),
                    "weights": torch.as_tensor(w, device=dev),
                    "active": torch.as_tensor(active, device=dev),
                    "round_ids": torch.arange(start_round, start_round + S,
                                              dtype=torch.int64, device=dev)}
        if arr is not None:
            schedule["arrival"] = torch.as_tensor(arr, device=dev)
        if self._server_opt is None:
            self.params, info = self.chunk_fn(self.params, self.data,
                                              schedule, self.base_key)
        else:
            (self.params, self.opt_state), info = self.chunk_fn(
                (self.params, self.opt_state), self.data, schedule,
                self.base_key)
        eval_acc = None
        if (start_round + S - 1) % self.sim.eval_every == 0:
            eval_acc = self._enqueue_eval(self.params)
        return start_round, list(subsets), info, eval_acc

    # -- server-state checkpointing (lifecycle format 4) ---------------------
    def export_state(self) -> dict:
        """Flat ``{path: numpy}`` snapshot of the server state (model
        params + optimizer moments when a server optimizer is active);
        rides ``TaskState.trainer_state`` in format-4 checkpoints
        (``lifecycle.save_state(..., trainer=...)``). The keys are the
        JAX package's: a flat parameter name's "." (the CNN's
        ``conv1.w``) is the reference's nesting, "/", so either
        package's trainer imports the other's export."""
        from repro_torch import checkpoint
        out = checkpoint.tree_to_arrays(self.params, "params")
        if self.opt_state is not None:
            out.update(checkpoint.tree_to_arrays(self.opt_state, "opt"))
        return {k.replace(".", "/"): v for k, v in out.items()}

    def import_state(self, arrays: dict) -> None:
        """Inverse of :meth:`export_state` (lifecycle resume path)."""
        from repro_torch import checkpoint
        ref = _ReferenceKeys(arrays)
        self.params = checkpoint.tree_from_arrays(self.params, ref, "params")
        if self.opt_state is not None:
            self.opt_state = checkpoint.tree_from_arrays(self.opt_state, ref,
                                                         "opt")

    # -- per-round TrainerFn protocol (round_chunk == 1) ---------------------
    def __call__(self, rnd: int, subset, weights) -> tuple:
        return self.run_rounds(rnd, [subset], [np.asarray(weights)])[0]

    @property
    def trainer(self):
        """The object itself: a chunk-capable ``core.lifecycle.Trainer``,
        also callable per round."""
        return self


def run_fl_experiment(kind: str, noniid: str, n_clients: int = 100,
                      rounds: int = 30, scheduler: str = "mkp",
                      n_train: int = 6000, n_test: int = 1500,
                      subset_size: int = 10, subset_delta: int = 3,
                      sim: SimConfig = SimConfig(),
                      seed: int = 0, data_plane: str = "host",
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

    ``data_plane="host"`` (the default, as in the reference) runs the
    host-loop trainer, one round a call (``round_chunk`` is forced to
    1); ``"device"`` stages the dataset on the device and runs
    ``round_chunk`` rounds per call through the chunk function.

    ``compression`` (a spec of fl.compression, also recorded on the
    ``TaskRequest``) and ``server_opt`` (``"fedadam"``/``"fedyogi"``)
    turn on the compressed update plane and the FedOpt server step; the
    round metrics then carry ``"bytes"``. Both need the device plane.

    ``selection_policy`` / ``scheduling_policy`` pick registered
    ``core.policy`` strategies; unset (``None``), the legacy
    ``scheduler`` alias decides (``"random"`` -> ``random_partition``).
    ``n_star`` defaults to ``n_clients`` when the budget is
    unconstrained (the paper's full-pool setup) and to 1 otherwise.

    ``fault_plan`` (a :class:`repro_torch.core.faults.FaultPlan`) injects
    deterministic stragglers, crashes and outages;
    ``overschedule_factor`` / ``quorum_frac`` / ``collect_deadline`` are
    the matching ``TaskRequest`` mitigations. All default off, and an
    inactive plan gives the no-fault run bit for bit.

    ``device=None`` runs on ``cuda`` and raises without it.
    """
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.fl.partition import partition_labels

    if data_plane not in ("host", "device"):
        raise ValueError(f"unknown data_plane {data_plane!r}")
    if data_plane == "host" and (compression or server_opt):
        raise ValueError("compression/server_opt need the device "
                         "data plane (data_plane='device')")
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
    if data_plane == "device":
        simul = DeviceFLSim(model_cfg, data, parts, test, sim,
                            pad_subset_to=subset_size + subset_delta,
                            fault_plan=fault_plan, compression=compression,
                            server_opt=server_opt, device=device)
    else:
        simul = FLClassificationSim(model_cfg, data, parts, test, sim,
                                    fault_plan=fault_plan, device=device)
        round_chunk = 1

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
    state, _ = lifecycle.drain(provider, state, simul.trainer,
                               stop_fn=lambda m: m["round"] + 1 >= rounds)
    result = lifecycle.as_run_result(state)
    return {"history": simul.history, "service": result, "state": state,
            "final_accuracy": simul.evaluate(), "scheduler": scheduler,
            "noniid": noniid, "kind": kind}
