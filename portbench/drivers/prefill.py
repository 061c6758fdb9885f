"""Prefill serving: batches of prompts through the port's
``models.transformer.prefill`` with its kernels on (``use_kernels``),
each batch's first tokens the argmax of its last logits, read on the
host.

Arrivals are open-loop at a fixed interval (``interval_ms``): batch i is
due at i x interval from the window's start and dispatched when due, or
at once when the one before finished late (``launch.serve`` holds one
batch at a time). A request's time to first token runs from its batch's
due time to its token on the host. The prompts are drawn on the device
from the seed, one distinct batch for each due time of the window.

The check: a sample of the served batches, drawn from the seed, is run
through the plain f32 reference; for each request, the gap by which the
served token's reference logit lies below the reference's best. The
largest gap is compared with its limit.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..reference.model import Model, f32_matmuls
from ..yardstick import flops, inputs, weights
from . import port_config, sync


class Driver:
    def __init__(self, spec, seed: int, device, spans, seconds: float):
        self.spec, self.seed, self.dev, self.spans = spec, seed, device, spans
        self.seconds = seconds
        self.cfg, self.tr = spec.config, spec.traffic

    def setup(self) -> None:
        from repro_torch.models import transformer as T
        self.T = T
        self.pcfg = port_config(self.cfg, use_kernels=True)
        self.params = weights.model_params(self.cfg, self.seed, self.dev)
        tr = self.tr
        self.interval = tr["interval_ms"] / 1e3
        n = int(self.seconds / self.interval) + 2
        self.prompts = inputs.prompts(n, tr["batch"], tr["prompt_len"],
                                      self.cfg["vocab_size"], self.seed + 1,
                                      self.dev)
        for i in range(min(tr["warmup_batches"], n)):
            self._serve(self.prompts[i])
        sync(self.dev)

    def _serve(self, prompt) -> torch.Tensor:
        with self.spans.span("prefill"):
            logits, cache, _ = self.T.prefill(self.pcfg, self.params, prompt)
        with self.spans.span("first_token"):
            tok = logits[:, -1].argmax(-1).cpu()
        del cache
        return tok

    def window(self, seconds: float) -> dict:
        n_max = self.prompts.shape[0]
        served, ttft, service = {}, [], []
        late = 0.0
        t0 = time.perf_counter()
        i = 0
        while i * self.interval < seconds and i < n_max:
            due = t0 + i * self.interval
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            else:
                late = max(late, -wait)
            start = time.perf_counter()
            served[i] = self._serve(self.prompts[i])
            done = time.perf_counter()
            service.append(done - start)
            ttft += [done - due] * self.prompts.shape[1]
            i += 1
        window_s = time.perf_counter() - t0
        self.served = served
        B, S = self.prompts.shape[1:]
        n_req = len(ttft)
        return {"attempted": n_req, "failed": 0, "units": n_req,
                "flops": len(served) * flops.forward_flops(self.cfg, B, S, 1),
                "metrics": {"ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3},
                "notes": {"requests": n_req, "batches": len(served),
                          "window_s": window_s,
                          "generator_late_max_ms": late * 1e3,
                          "service_ms_quartiles": [
                              float(v) * 1e3 for v in
                              np.percentile(service, [0, 25, 50, 75, 100])]}}

    def costs(self) -> dict:
        cfg, tr = self.cfg, self.tr
        B, S = tr["batch"], tr["prompt_len"]
        d, H, G = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
        hd = flops.head_dim(cfg)
        return {"swiglu": flops.swiglu_cost(B * S, d, cfg["d_ff"]) + (None,),
                "flash_attention": flops.flash_attention_cost(
                    B, H, G, S, hd) + (None,)}

    def release(self) -> None:
        del self.T
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[int]:
        """The served batches the check reads, drawn from the seed."""
        ids = sorted(self.served)
        k = min(self.tr["check_batches"], len(ids))
        rng = np.random.default_rng(self.seed)
        return sorted(rng.choice(ids, size=k, replace=False).tolist())

    def reference_gaps(self, batches, lowp=None) -> list[float]:
        """For each request of ``batches``: the gap below the reference's
        best logit of the token served (``lowp=None``), or of the token
        the reference computed with ``lowp`` puts first (the control)."""
        ref = Model(self.cfg, self.params)
        low = None if lowp is None else Model(self.cfg, self.params, lowp)
        step = self.tr.get("check_rows", 1)
        gaps = []
        with torch.no_grad(), f32_matmuls():
            for i in batches:
                p = self.prompts[i]
                for r in range(0, p.shape[0], step):
                    rows = p[r:r + step]
                    lg = ref.last_logits(rows)
                    if low is None:
                        tok = self.served[i][r:r + step].to(lg.device)
                    else:
                        tok = low.last_logits(rows).argmax(-1)
                    best = lg.max(-1).values
                    gaps += (best - lg.gather(-1, tok[:, None])[:, 0]).tolist()
        return gaps

    def check(self) -> list:
        gaps = self.reference_gaps(self.sample())
        return [("served_logit_gap", max(gaps))]
