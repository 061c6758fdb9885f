"""FedSGD at full width: each step trains one batch of the scheduled
clients' rows through ``fl.round.make_fedsgd_step`` (autograd over the
whole model, the port's plain path) with ``optim.adam`` under
``optim.warmup_cosine`` and global-norm clipping, and reads every loss
on the host, as ``launch.train.train`` does; the window reads each one
once the next step is launched, and copies each batch in from pinned
memory without waiting, so the card is not left idle between steps
while the host works. Stage 2
(``core.generate_subsets``) schedules the clients; each step takes the
next subset. The batch has ``batch`` rows whatever the subset's size:
each client gives batch // k rows (the first batch % k one more), drawn
from its samples by the seed's generator, each weighted p_k / its rows.

Set-up draws the weights, builds the step and the optimizer, and drives
the first ``check_steps`` steps through the window's own call and feed.
The check follows them with the plain f32 reference from the same
weights and rows: each step's loss, the first gradient as Adam took it
(its first moment after one step over 1 - b1) and the parameters'
change after the last, leaf by leaf.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..reference.fedsgd import FedSGD, flatten
from ..reference.model import f32_matmuls
from ..yardstick import flops, inputs, weights
from . import port_config, sync
from .compare import leaf_gap


class Driver:
    def __init__(self, spec, seed: int, device, spans, seconds: float):
        self.spec, self.seed, self.dev, self.spans = spec, seed, device, spans
        self.cfg, self.tr = spec.config, spec.traffic

    def setup(self) -> None:
        from repro_torch import optim
        from repro_torch.core import generate_subsets
        from repro_torch.fl import round as fl_round
        from repro_torch.models import transformer as T
        tr, cfg = self.tr, self.cfg
        n = tr["clients"] * tr["seqs_per_client"]
        self.tokens, labels = inputs.lm_data(n, tr["seq_len"], cfg["vocab_size"],
                                             self.seed)
        self.parts = inputs.partition(labels, tr["clients"], tr["noniid"], 10,
                                      self.seed)
        hists = {i: np.bincount(labels[p], minlength=10).astype(np.float64)
                 for i, p in enumerate(self.parts)}
        self.subsets = generate_subsets(hists, n=tr["subset"],
                                        delta=tr["subset_delta"],
                                        x_star=tr["x_star"]).subsets
        self.sizes = np.array([len(p) for p in self.parts], np.float64)
        self.rng = np.random.default_rng(self.seed)
        pcfg = port_config(cfg)
        self.optimizer = optim.adam(
            optim.warmup_cosine(tr["lr"], tr["warmup"], tr["total_steps"]),
            grad_clip=tr["grad_clip"])
        self.step_fn = fl_round.make_fedsgd_step(
            lambda p, b: T.loss_fn(pcfg, p, b), self.optimizer)
        self.params0 = weights.model_params(cfg, self.seed, self.dev)
        self.params, self.opt = self.params0, self.optimizer.init(self.params0)
        self.steps = 0
        self.first_batches, self.first_losses = [], []
        for i in range(tr["check_steps"]):
            b = self.batch()
            self.first_batches.append(b)
            self.first_losses.append(self.train(b))
            if i == 0:
                self.m1 = self.opt["m"]
        self.params3 = self.params
        sync(self.dev)

    def batch(self) -> dict:
        tr = self.tr
        sub = self.subsets[self.steps % len(self.subsets)]
        k = len(sub)
        p = self.sizes[sub] / self.sizes[sub].sum()
        idx, wts = [], []
        for j, cid in enumerate(sub):
            c = tr["batch"] // k + (j < tr["batch"] % k)
            part = self.parts[cid]
            idx.extend(self.rng.choice(part, size=c, replace=len(part) < c))
            wts.extend([p[j] / c] * c)
        t = self.to_device(self.tokens[np.asarray(idx)].astype(np.int64))
        return {"tokens": t[:, :-1], "targets": t[:, 1:],
                "weights": self.to_device(np.asarray(wts, np.float32))}

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.dev.type != "cuda":
            return t
        return t.pin_memory().to(self.dev, non_blocking=True)

    def launch(self, b) -> torch.Tensor:
        """One step, launched; returns its loss on the device."""
        with self.spans.span("step"):
            self.params, self.opt, m = self.step_fn(self.params, self.opt, b)
        self.steps += 1
        return m["loss"]

    def read(self, loss: torch.Tensor) -> float:
        with self.spans.span("loss_read"):
            return float(loss)

    def train(self, b) -> float:
        return self.read(self.launch(b))

    def window(self, seconds: float) -> dict:
        steps = failed = 0
        pending = None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with self.spans.span("batch"):
                b = self.batch()
            loss = self.launch(b)
            if pending is not None:
                failed += not np.isfinite(self.read(pending))
            pending = loss
            steps += 1
        if pending is not None:
            failed += not np.isfinite(self.read(pending))
        sync(self.dev)
        window_s = time.perf_counter() - t0
        tr = self.tr
        tokens = steps * tr["batch"] * tr["seq_len"]
        return {"attempted": steps, "failed": failed, "units": steps,
                "flops": steps * flops.train_flops(self.cfg, tr["batch"],
                                                   tr["seq_len"]),
                "metrics": {"train_tok_s": tokens / window_s},
                "notes": {"steps": steps, "window_s": window_s}}

    def costs(self) -> dict:
        return {}

    def release(self) -> None:
        del self.params, self.opt, self.step_fn
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, lowp=None) -> FedSGD:
        tr = self.tr
        return FedSGD(self.cfg, self.params0, lr=tr["lr"], warmup=tr["warmup"],
                      total=tr["total_steps"], clip=tr["grad_clip"],
                      rows=tr["check_rows"], lowp=lowp)

    def follow(self, ref: FedSGD):
        """(losses, first clipped gradient, change after the last step)."""
        losses = []
        with f32_matmuls():
            for i, b in enumerate(self.first_batches):
                loss, g = ref.step(b)
                losses.append(loss)
                if i == 0:
                    g1 = g
        p0 = flatten(self.params0)
        change = {n: ref.p[n] - p0[n].to(torch.float32) for n in p0}
        return losses, g1, change

    def readings(self, ref, prog=None) -> list:
        if prog is None:
            p0, p3 = flatten(self.params0), flatten(self.params3)
            g1 = {n: v / (1 - 0.9) for n, v in flatten(self.m1).items()}
            prog = (self.first_losses, g1,
                    {n: p3[n].to(torch.float32) - p0[n].to(torch.float32)
                     for n in p0})
        r_loss, r_g1, r_change = ref
        norms = {n: float(v.norm()) for n, v in r_g1.items()}
        med = float(np.median(list(norms.values())))
        keep = [n for n, v in norms.items() if v > 1e-3 * med]
        loss_gap = max(abs(a - b) / max(abs(b), 1e-12)
                       for a, b in zip(prog[0], r_loss))
        return [("loss_gap", loss_gap),
                ("grad1_gap", leaf_gap(prog[1], r_g1, keep)),
                ("last_change_gap", leaf_gap(prog[2], r_change, keep))]

    def check(self) -> list:
        return self.readings(self.follow(self.reference()))
