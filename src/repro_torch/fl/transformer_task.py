"""Federated transformer fine-tuning with LoRA adapter deltas.

Clients fine-tune a transformer from the config zoo (SmolLM-360M's
architecture, reduced for tests or at full width) on class-conditional
bigram streams (``data.synthetic.make_lm_data``), but the *server state
that crosses the wire is only a LoRA adapter tree*: the frozen backbone
stays on every device and client deltas are adapter deltas, which is
what the compressed update plane (fl.compression,
``TaskRequest.compression``) acts on.

LoRA here is the functional formulation: an adapter for target leaf W
(stacked over layers, shape ``(L, din, ...)``) is a pair
``a (L, din, r)``, ``b (L, r, dout)`` and the effective weight is
``W + (alpha/r)·a@b`` reshaped back — ``b`` starts at zero so the
merged model equals the backbone at round 0. Targets are leaves whose
*first* trailing dim is the input dim (wq/wv/w_up by default), so one
einsum covers attention and MLP uniformly.

The adapter tree is a flat dict keyed ``"<block>/<leaf>/a"`` and
``".../b"`` (the round plane's parameter form): sorted, those keys are
the JAX package's leaf order of its nested ``{path: {"a", "b"}}`` tree,
so flattened deltas have the reference's columns and exported state has
its keys.

:class:`TransformerFLSim` subclasses the device data-plane trainer
(fl.simulation.DeviceFLSim): the same segmentation DP, async
dispatch/collect split, arrival masks and export/import checkpoint seam;
only the model plumbing (adapter params, LM gather, merged next-token
eval) differs. Local training runs the plain model under ``torch.func``
autograd: no kernel has a backward, so the loss always runs with
``use_kernels=False``. The aggregate is the ``fedavg_agg_quality``
kernel over the adapter deltas, or the codec kernels with
``compression``. :func:`make_transformer_fl` builds the whole bundle
(trainer + pool + partitions) for tests and benchmarks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import optim
from repro_torch import random as trandom
from repro_torch.configs import smollm_360m
from repro_torch.data.synthetic import LMData, make_lm_data
from repro_torch.device import resolve_device
from repro_torch.fl import device_data
from repro_torch.fl.partition import partition_labels
from repro_torch.fl.round import make_fl_rounds_scan
from repro_torch.fl.simulation import DeviceFLSim, SimConfig, pool_from_partition
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Adapter shape: rank-r factors on ``targets`` (paths into one
    stacked layer dict, ``<block>/<leaf>``). Every default target has
    its input dim first (wq/wv: (d, heads, hd); w_up: (d, d_ff)), the
    layout :func:`merge_adapters` assumes."""
    rank: int = 4
    alpha: float = 8.0
    targets: tuple = ("attn/wq", "attn/wv", "mlp/w_up")


def _get_leaf(layers, path: str):
    node = layers
    for part in path.split("/"):
        node = node[part]
    return node


def init_adapters(layers, lora: LoraConfig, gen: torch.Generator) -> dict:
    """Flat adapter dict for stacked layer params: ``{path + "/a",
    path + "/b"}`` for every target.

    ``a`` ~ N(0, 0.02), drawn from ``gen`` on its device, ``b`` = 0 (the
    standard LoRA init: the merged model starts exactly at the
    backbone). f32 whatever the backbone's dtype: adapters are the
    optimizer-visible state."""
    out = {}
    for path in lora.targets:
        leaf = _get_leaf(layers, path)
        L, din = leaf.shape[0], leaf.shape[1]
        dout = int(np.prod(leaf.shape[2:]))
        out[path + "/a"] = 0.02 * torch.randn(
            (L, din, lora.rank), generator=gen, dtype=torch.float32,
            device=gen.device)
        out[path + "/b"] = torch.zeros((L, lora.rank, dout),
                                       dtype=torch.float32, device=gen.device)
    return out


def merge_adapters(params, adapters: dict, lora: LoraConfig):
    """Backbone params with each target leaf replaced by
    ``W + (alpha/rank)·a@b`` (reshaped, cast back to W.dtype). A pure
    function of (params, adapters), so ``torch.func`` transforms it:
    client training differentiates the merged forward with respect to
    the adapters only."""
    scale = lora.alpha / lora.rank
    layers = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in params["layers"].items()}
    for path in lora.targets:
        block, leaf_name = path.split("/")
        base = layers[block][leaf_name]
        delta = torch.einsum("lir,lro->lio", adapters[path + "/a"],
                             adapters[path + "/b"]) * scale
        layers[block][leaf_name] = base + delta.reshape(base.shape).to(
            base.dtype)
    return {**params, "layers": layers}


def reduced_lm_config(vocab_size: int = 64,
                      num_layers: int = 2) -> ModelConfig:
    """The federated LM backbone: SmolLM-360M's architecture reduced to
    CPU-smoke size (2 heads x 64 head dim, f32)."""
    return smollm_360m.config().reduced(num_layers=num_layers,
                                        d_model=128, vocab=vocab_size)


class TransformerFLSim(DeviceFLSim):
    """Device-resident federated LoRA fine-tuning trainer.

    ``self.params`` is the *adapter* dict (the server state: what client
    deltas perturb, what FedAdam/FedYogi steps, what format-4
    checkpoints carry); the frozen backbone ``self.base_params`` is read
    by the loss at every call. Everything else — chunk segmentation,
    async dispatch/collect, fault-mode arrival masks, export/import — is
    inherited from :class:`~repro_torch.fl.simulation.DeviceFLSim`.

    ``device=None`` runs on ``cuda`` and raises without it. The backbone
    and adapters are drawn from ``torch.Generator(device)`` seeded with
    ``sim.seed``; to start from the reference's weights, assign
    ``transformer.params_from_jax(...)`` to ``base_params`` and the
    reference's adapters (flattened to this class's keys) to ``params``
    before the first round (the optimizer state is zeros of the same
    shapes, so it need not be rebuilt).
    """

    # place_on moves the frozen backbone and the test sequences too
    _PLACED = ("params", "opt_state", "data", "base_key", "base_params",
               "_test_seqs")

    def __init__(self, model_cfg: ModelConfig, data: LMData, parts,
                 test: LMData, sim: SimConfig = SimConfig(),
                 lora: LoraConfig = LoraConfig(),
                 pad_subset_to: int | None = None, fault_plan=None,
                 compression: str | None = None,
                 server_opt: str | None = None, device=None):
        self.device = resolve_device(device)
        # no kernel has a backward: the loss runs the plain model
        self.cfg = dataclasses.replace(model_cfg, use_kernels=False)
        self.lora = lora
        self.pad_subset_to = pad_subset_to
        self.fault_plan = fault_plan
        self.base_key = trandom.prng_key(sim.seed, self.device)
        gen = torch.Generator(self.device).manual_seed(sim.seed)
        self.base_params = transformer.init_params(self.cfg, gen)
        self.params = init_adapters(self.base_params["layers"], lora, gen)
        self._server_opt = None if server_opt is None \
            else optim.make(server_opt, sim.server_lr)
        self.opt_state = None if self._server_opt is None \
            else self._server_opt.init(self.params)
        self.data = device_data.DeviceLMDataset.stage(data, parts,
                                                      self.device)
        self.chunk_fn = make_fl_rounds_scan(
            self._loss, local_lr=sim.local_lr, local_steps=sim.local_steps,
            batch_size=sim.batch_size, server_lr=sim.server_lr,
            dropout_rate=sim.dropout_rate, compression=compression,
            server_opt=self._server_opt,
            gather_fn=device_data.gather_lm_batches)
        # deterministic eval: next-token accuracy of the merged model
        # over the full held-out set (no sampling rng: resume-exact)
        self.sim = sim
        self.history = []
        self._test_seqs = torch.as_tensor(np.asarray(test.tokens, np.int64),
                                          device=self.device)

    def _loss(self, adapters, batch):
        merged = merge_adapters(self.base_params, adapters, self.lora)
        return transformer.loss_fn(self.cfg, merged, batch)

    @torch.no_grad()
    def _enqueue_eval(self, params, n: int = 1024):
        """Next-token accuracy on the full cached test set (a device
        scalar the host has not waited for; deterministic, no rng
        draw)."""
        merged = merge_adapters(self.base_params, params, self.lora)
        seqs = self._test_seqs
        logits, _ = transformer.forward(self.cfg, merged, seqs[:, :-1])
        return (logits.argmax(-1) == seqs[:, 1:]).to(torch.float32).mean()

    def evaluate(self, n: int = 1024) -> float:
        return float(self._enqueue_eval(self.params))


def make_transformer_fl(n_clients: int = 20, n_train: int = 400,
                        n_test: int = 120, seq_len: int = 16,
                        vocab_size: int = 64, noniid: str = "type2",
                        num_layers: int = 2, seed: int = 0,
                        sim: SimConfig | None = None,
                        lora: LoraConfig = LoraConfig(),
                        pad_subset_to: int | None = None,
                        compression: str | None = None,
                        server_opt: str | None = None,
                        fault_plan=None, device=None) -> dict:
    """Build the full federated LM bundle: reduced SmolLM backbone,
    bigram LM data split train/test, a paper-style non-iid partition
    with its client pool (latent bigram classes are the scheduler's
    labels), and a ready :class:`TransformerFLSim` on ``device``.

    Returns ``{"trainer", "pool", "parts", "cfg", "data", "test"}`` —
    enough to drive ``core.lifecycle`` directly (tests, benchmarks).
    """
    if sim is None:
        sim = SimConfig(batch_size=4, local_steps=2, local_lr=5.0,
                        server_lr=1.0, dropout_rate=0.0, eval_every=10_000,
                        seed=seed)
    cfg = reduced_lm_config(vocab_size, num_layers)
    full = make_lm_data(n_train + n_test, seq_len, vocab_size, seed=seed)
    data = LMData(full.tokens[:n_train], full.labels[:n_train],
                  full.num_classes, vocab_size)
    test = LMData(full.tokens[n_train:], full.labels[n_train:],
                  full.num_classes, vocab_size)
    parts = partition_labels(data.labels, n_clients, noniid,
                             data.num_classes, seed=seed)
    pool = pool_from_partition(data.labels, parts, data.num_classes,
                               seed=seed)
    trainer = TransformerFLSim(cfg, data, parts, test, sim, lora,
                               pad_subset_to=pad_subset_to,
                               fault_plan=fault_plan,
                               compression=compression,
                               server_opt=server_opt, device=device)
    return {"trainer": trainer, "pool": pool, "parts": parts, "cfg": cfg,
            "data": data, "test": test}
