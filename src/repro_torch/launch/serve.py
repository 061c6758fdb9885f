"""Serving entry point: batched prefill + decode loop through the port's
kernels (``use_kernels=True``) on a reduced dense architecture, on the
card unless the caller asks for the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str = "smollm-360m", batch: int = 4, prompt_len: int = 32,
          new_tokens: int = 16, seed: int = 0, greedy: bool = True,
          verbose: bool = True, device=None) -> torch.Tensor:
    """Generate ``new_tokens`` tokens for ``batch`` random prompts of
    ``prompt_len`` tokens (numpy ``default_rng(seed)``, as the reference
    draws them) with random weights drawn from ``torch.Generator`` seeded
    with ``seed`` on the device. Returns the tokens, (batch, new_tokens)
    int32. The first token is the argmax of the prefill logits either
    way, as in the reference; with ``greedy=False`` the decode steps
    sample, from a generator seeded with ``seed + 1``."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config(arch).reduced(), use_kernels=True)
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt_len)),
                              dtype=torch.int32, device=dev)
    sampler = torch.Generator(dev).manual_seed(seed + 1)

    def pick(logits, sample):
        last = logits[:, -1].to(torch.float32)
        if not sample:
            return last.argmax(-1, keepdim=True).to(torch.int32)
        return torch.multinomial(torch.softmax(last, -1), 1,
                                 generator=sampler).to(torch.int32)

    t0 = time.perf_counter()
    logits, cache, memory = T.prefill(cfg, params, prompts)
    cache = T.grow_cache(cfg, cache, extra=new_tokens)
    tok = pick(logits, sample=False)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for step in range(new_tokens - 1):
        logits, cache = T.decode_step(cfg, params, tok, cache,
                                      prompt_len + step, memory=memory)
        tok = pick(logits, sample=not greedy)
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    if verbose:
        print(f"arch={cfg.name} device={dev} prefill({batch}x{prompt_len})="
              f"{t_prefill:.2f}s decode {new_tokens} toks={t_decode:.2f}s "
              f"({batch * new_tokens / max(t_decode, 1e-9):.1f} tok/s)")
        print("generated:", tokens[0, :12].cpu().numpy())
    return tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    serve(args.arch, args.batch, args.prompt, args.tokens, args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
