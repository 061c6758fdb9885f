"""Training entry point: FedSGD on a reduced variant of ``--arch`` over
synthetic federated LM data, with the paper's scheduler choosing each
step's client subset (stage 2's ``generate_subsets``) and the FedAvg
weights p_k folded into a per-example loss weight
(``fl.round.make_fedsgd_step``), on the card unless the caller asks for
the CPU. The model runs its plain path: no kernel has a backward.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import generate_subsets, participation_weights
from repro_torch.data.synthetic import make_lm_data
from repro_torch.device import resolve_device
from repro_torch.fl.partition import client_histograms, partition_labels
from repro_torch.fl.round import make_fedsgd_step
from repro_torch.models import transformer as T
from repro_torch.optim import adam, tree_leaves, warmup_cosine


def make_extras(cfg, B, rng, device):
    """The stub frontend's inputs, f32 normals from ``rng``: patch
    embeddings for a vision config, frames for an encoder-decoder."""
    extras = {}
    stub = lambda: torch.as_tensor(rng.normal(size=(
        B, cfg.frontend_seq, cfg.frontend_dim)), dtype=torch.float32,
        device=device)
    if cfg.family == "vlm" and cfg.frontend_seq:
        extras["patch_embeds"] = stub()
    if cfg.is_enc_dec:
        extras["frames"] = stub()
    return extras


def client_batch(cfg, data, parts, hists, subset, batch, rng, device):
    """One step's batch, composed as the reference composes it: each
    scheduled client contributes batch/|subset| sequences drawn from its
    partition by ``rng``, each weighted p_k / (its count)."""
    w = participation_weights(hists, subset)
    per = max(batch // len(subset), 1)
    idx, wts = [], []
    for cid, pk in zip(subset, w):
        take = rng.choice(parts[cid], size=per,
                          replace=len(parts[cid]) < per)
        idx.extend(take)
        wts.extend([pk / per] * per)
    toks = torch.as_tensor(np.asarray(data.tokens)[np.asarray(idx)],
                           dtype=torch.int64, device=device)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
           "weights": torch.as_tensor(np.asarray(wts), dtype=torch.float32,
                                      device=device)}
    out.update(make_extras(cfg, len(idx), rng, device))
    return out


def train(cfg, data, parts, hists, *, steps: int, batch: int, subset: int,
          lr: float, seed: int, device, ckpt_dir: str | None = None) -> dict:
    """The reference's step loop on ``device``: weights from
    ``torch.Generator(device)`` seeded with ``seed``, batches from numpy
    ``default_rng(seed)``, ``adam(warmup_cosine(lr, 10, steps),
    grad_clip=1.0)``, a checkpoint every 25 steps into ``ckpt_dir``.
    Returns ``{"losses", "params", "opt_state", "step_s"}``, ``step_s``
    each step's wall time (the loss read ends each step)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, use_kernels=False)
    rng = np.random.default_rng(seed)
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    optimizer = adam(warmup_cosine(lr, 10, steps), grad_clip=1.0)
    opt_state = optimizer.init(params)
    step_fn = make_fedsgd_step(lambda p, b: T.loss_fn(cfg, p, b), optimizer)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    sched = generate_subsets(hists, n=subset, delta=1, x_star=3)
    print(f"arch={cfg.name} device={dev} params="
          f"{sum(x.numel() for x in tree_leaves(params)):,} "
          f"rounds/period={sched.num_rounds}")

    t0 = time.time()
    losses, step_s = [], []
    for step in range(steps):
        t = time.perf_counter()
        b = client_batch(cfg, data, parts, hists,
                         sched.subsets[step % sched.num_rounds], batch, rng,
                         dev)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t)
        if step % 10 == 0 or step == steps - 1:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.1f}s)")
        if mgr and (step + 1) % 25 == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
    print(f"final loss {np.mean(losses[-5:]):.4f} "
          f"(first {np.mean(losses[:5]):.4f})")
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "step_s": step_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--subset", type=int, default=4)
    ap.add_argument("--noniid", default="type2",
                    choices=["type1", "type2", "type3", "iid"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    data = make_lm_data(args.clients * 64, args.seq, cfg.vocab_size,
                        seed=args.seed)
    parts = partition_labels(data.labels, args.clients, args.noniid,
                             data.num_classes, seed=args.seed)
    hists = client_histograms(data.labels, parts, data.num_classes)
    return train(cfg, data, parts, hists, steps=args.steps,
                 batch=args.batch, subset=args.subset, lr=args.lr,
                 seed=args.seed, device=args.device,
                 ckpt_dir=args.ckpt_dir)["losses"]


if __name__ == "__main__":
    main()
