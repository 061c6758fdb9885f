"""The federated LoRA task through the service loop: stage 1 seats the
pool, stage 2 schedules each period, ``TransformerFLSim`` (the device
plane, ``fl.round.make_fl_rounds_scan``) trains a chunk of rounds a
``lifecycle.step``, and ``fedavg_agg_quality`` aggregates each round.

Set-up builds the provider, the trainer and the task, puts the
backbone and the adapters drawn from the seed into the trainer, and
drives the task through ``lifecycle.step`` as the window does, in
chunks of ``round_chunk`` rounds, until ``check_rounds`` rounds are
done, keeping the adapters after each chunk. The window then steps the
task on until ``--seconds`` have passed, and counts the rounds
completed.

The check runs the plain f32 reference over those first rounds from the
same adapters, on the program's subsets, and compares every round's q
cosines, the adapters' change after the first chunk and after each
later chunk (the worst leaf's norm, and the whole change's difference
over its norm); every schedule of the run is held to stage 2's
guarantees. The rounds' losses
are not compared: neither the control nor a fault moves them three times
past the program's own gap.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..reference.fl_round import LoraRound
from ..reference.model import f32_matmuls
from ..yardstick import flops, inputs, weights
from . import port_config, sync
from .compare import leaf_gap, rel_diff


class Driver:
    def __init__(self, spec, seed: int, device, spans, seconds: float):
        self.spec, self.seed, self.dev, self.spans = spec, seed, device, spans
        self.cfg, self.tr = spec.config, spec.traffic

    def setup(self) -> None:
        from repro_torch.core import FLServiceProvider, TaskRequest, lifecycle
        from repro_torch.data.synthetic import LMData
        from repro_torch.fl.simulation import SimConfig, pool_from_partition
        from repro_torch.fl.transformer_task import LoraConfig, TransformerFLSim
        tr, cfg, dev = self.tr, self.cfg, self.dev
        self.lifecycle = lifecycle
        t = time.perf_counter()
        n_train = tr["clients"] * tr["seqs_per_client"]
        toks, labels = inputs.lm_data(n_train + tr["test_seqs"], tr["seq_len"],
                                      cfg["vocab_size"], self.seed)
        self.tokens = toks[:n_train]
        self.parts = inputs.partition(labels[:n_train], tr["clients"],
                                      tr["noniid"], 10, self.seed)
        data = LMData(toks[:n_train], labels[:n_train], 10, cfg["vocab_size"])
        test = LMData(toks[n_train:], labels[n_train:], 10, cfg["vocab_size"])
        pool = pool_from_partition(labels[:n_train], self.parts, 10,
                                   seed=self.seed)
        sim = SimConfig(batch_size=tr["batch"], local_steps=tr["local_steps"],
                        local_lr=tr["local_lr"], server_lr=tr["server_lr"],
                        dropout_rate=0.0, eval_every=1 << 30, seed=self.seed)
        lora = LoraConfig(rank=tr["lora_rank"], alpha=tr["lora_alpha"],
                          targets=tuple(tr["lora_targets"]))
        t_data = time.perf_counter()
        trainer = TransformerFLSim(port_config(cfg), data, self.parts, test,
                                   sim, lora, device=dev)
        sync(dev)
        t_trainer = time.perf_counter()
        self.base = weights.model_params(cfg, self.seed, dev)
        self.adapters0 = weights.lora_adapters(cfg, lora.targets, lora.rank,
                                               self.seed, dev)
        trainer.base_params = self.base
        trainer.params = {n: v.clone() for n, v in self.adapters0.items()}
        self.provider = FLServiceProvider(pool)
        self.task = TaskRequest(
            budget=1e12, n_star=tr["clients"], subset_size=tr["subset"],
            subset_delta=tr["subset_delta"], x_star=tr["x_star"],
            max_periods=1 << 30, seed=self.seed % (1 << 32),
            round_chunk=tr["round_chunk"])
        self.spans.wrap(self.provider, "schedule_period")
        self.results = []
        collect = trainer.collect

        def collect_kept(handles):
            out = collect(handles)
            self.results.extend(out)
            return out

        trainer.collect = collect_kept
        self.spans.wrap(trainer, "collect")
        self.trainer = trainer
        sync(dev)
        t_weights = time.perf_counter()
        self.state = lifecycle.submit(self.provider, self.task)
        # the first chunks through the window's own call, the adapters
        # kept after each: (rounds done, adapters)
        self.events, self.snaps = [], []
        while len(self.events) < tr["check_rounds"]:
            self.state, ev = lifecycle.step(self.provider, self.state, trainer)
            if ev:
                self.events += ev
                self.snaps.append((len(self.events), {
                    n: v.clone() for n, v in trainer.params.items()}))
        self.q_first = [np.asarray(q) for _, q, _ in
                        self.results[:len(self.events)]]
        sync(dev)
        self.setup_phases_s = {"data": t_data - t, "trainer": t_trainer - t_data,
                               "weights": t_weights - t_trainer,
                               "first_rounds": time.perf_counter() - t_weights}

    def window(self, seconds: float) -> dict:
        rounds = failed = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with self.spans.span("lifecycle.step"):
                self.state, ev = self.lifecycle.step(self.provider, self.state,
                                                     self.trainer)
            rounds += len(ev)
            failed += sum(not np.isfinite(e.metrics["loss"]) for e in ev)
            if self.state.phase.terminal:
                raise RuntimeError(f"the task ended: {self.state.phase.name}")
        sync(self.dev)
        window_s = time.perf_counter() - t0
        tr = self.tr
        per_round = tr["subset"] * tr["local_steps"] * flops.lora_step_flops(
            self.cfg, tr["batch"], tr["seq_len"], tr["lora_rank"],
            tr["lora_targets"])
        return {"attempted": rounds, "failed": failed, "units": rounds,
                "flops": rounds * per_round,
                "metrics": {"round_ms": window_s * 1e3 / max(rounds, 1)},
                "notes": {"rounds": rounds, "window_s": window_s,
                          "periods": self.state.period}}

    def costs(self) -> dict:
        from ..yardstick.peaks import PEAK_F32_FLOPS
        K = self.tr["subset"] + self.tr["subset_delta"]
        P = sum(v.numel() for v in self.adapters0.values())
        return {"fedavg_agg_quality": flops.fedavg_agg_quality_cost(K, P)
                + (PEAK_F32_FLOPS,)}

    def release(self) -> None:
        self.schedules = list(self.state.schedules)
        self.all_events = list(self.state.rounds)
        del self.trainer, self.state, self.provider
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def schedule_violations(self) -> dict:
        """Stage 2's guarantees over every period of the run (Algorithm
        1): each subset 1 to n + delta distinct clients of the task; every
        client of the period's pool in at least one subset and in at most
        x*; each round's weights n_k / sum n_k from the benchmark's own
        partition. Returns the count of each kind broken."""
        tr = self.tr
        hi = tr["subset"] + tr["subset_delta"]
        bad = {"size": 0, "coverage": 0, "x_star": 0, "weights": 0}
        for s in self.schedules:
            counts: dict[int, int] = {}
            for sub in s.subsets:
                bad["size"] += not (1 <= len(sub) <= hi
                                    and len(set(sub)) == len(sub))
                for c in sub:
                    counts[c] = counts.get(c, 0) + 1
            bad["coverage"] += sum(counts.get(c, 0) < 1 for c in s.counts)
            bad["coverage"] += sum(c not in s.counts for c in counts)
            bad["x_star"] += sum(n > tr["x_star"] for n in counts.values())
        sizes = np.array([len(p) for p in self.parts], np.float64)
        for e in self.all_events:
            want = sizes[e.subset] / sizes[e.subset].sum()
            bad["weights"] += not np.allclose(e.weights, want, rtol=1e-12,
                                              atol=0)
        return bad

    def reference(self, lowp=None, adapter_lowp=None) -> LoraRound:
        tr = self.tr
        return LoraRound(self.cfg, self.base, self.adapters0,
                         tokens=self.tokens, parts=self.parts, seed=self.seed,
                         rank=tr["lora_rank"], alpha=tr["lora_alpha"],
                         steps=tr["local_steps"], batch=tr["batch"],
                         local_lr=tr["local_lr"], server_lr=tr["server_lr"],
                         lowp=lowp, adapter_lowp=adapter_lowp)

    def follow(self, ref: LoraRound):
        """The reference over the checked rounds, on the program's
        subsets: [(loss, q, adapters after)] a round."""
        sizes = np.array([len(p) for p in self.parts], np.float64)
        out = []
        with f32_matmuls():
            for e in self.events:
                loss, q, _ = ref.run(e.round_index, e.subset, sizes[e.subset])
                out.append((loss, q, {n: v.clone()
                                      for n, v in ref.adapters.items()}))
        return out

    def _program(self) -> list:
        """[(loss, q, adapters after the round or None)] a checked round:
        the program's adapters are kept at the end of each chunk."""
        kept = {n - 1: a for n, a in self.snaps}
        return [(e.metrics["loss"], q, kept.get(i)) for i, (e, q) in
                enumerate(zip(self.events, self.q_first))]

    def _delta(self, adapters: dict, device) -> dict:
        a0 = self.adapters0
        return {n: (adapters[n].to(torch.float32) - a0[n].to(torch.float32))
                .to(device) for n in a0}

    def readings(self, ref_rounds, prog=None) -> list:
        """The numbers compared: [(name, value)]. ``prog`` is [(loss, q,
        adapters)] a round of the side judged (default: the program's);
        the adapters are compared at the program's chunk ends."""
        prog = self._program() if prog is None else prog
        q_gap = max(float(np.max(np.abs(np.asarray(p[1]) - r[1])))
                    for p, r in zip(prog, ref_rounds))
        dev = next(iter(ref_rounds[0][2].values())).device
        ends = [n - 1 for n, _ in self.snaps]
        changes = [(self._delta(prog[i][2], dev),
                    self._delta(ref_rounds[i][2], dev)) for i in ends]
        keep = _moving(changes[0][1])
        return [("q_gap", q_gap),
                ("chunk1_change_gap", leaf_gap(*changes[0], keep)),
                ("later_change_gap", max((leaf_gap(p, r, keep)
                                          for p, r in changes[1:]),
                                         default=0.0)),
                ("change_rel_diff", max(rel_diff(p, r) for p, r in changes))]

    def detail(self, ref_rounds, prog=None) -> dict:
        """Each leaf's change at each chunk end (the program's norm and
        the reference's), and every q gap: where the worst readings come
        from."""
        prog = self._program() if prog is None else prog
        dev = next(iter(ref_rounds[0][2].values())).device
        out = {}
        for n, _ in self.snaps:
            p = self._delta(prog[n - 1][2], dev)
            r = self._delta(ref_rounds[n - 1][2], dev)
            out[f"after_round_{n}"] = {k: [float(p[k].norm()),
                                           float(r[k].norm())] for k in r}
        out["q"] = [np.round(np.asarray(p[1]) - r[1], 5).tolist()
                    for p, r in zip(prog, ref_rounds)]
        return out

    def check(self) -> list:
        ref_rounds = self.follow(self.reference())
        return [(f"schedule_{k}", v)
                for k, v in self.schedule_violations().items()] \
            + self.readings(ref_rounds)


def _moving(first: dict) -> list[str]:
    """Leaves whose first change in the reference is above a thousandth
    of the median leaf's: the others move by round-off alone."""
    norms = {n: float(v.norm()) for n, v in first.items()}
    med = float(np.median(list(norms.values())))
    return [n for n, v in norms.items() if v > 1e-3 * med]
