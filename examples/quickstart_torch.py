"""Quickstart on the PyTorch port: the paper's two-stage pipeline.

1. Register heterogeneous clients with multi-criteria scores.
2. Stage 1 — select an initial client pool under a budget (greedy knapsack).
3. Stage 2 — schedule per-round subsets with near-uniform integrated data
   (MKP, Algorithm 1) and check the fairness guarantee.
4. Run a few federated rounds of the paper's CNN on synthetic non-iid
   data, on the card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (FLServiceProvider, TaskRequest, fairness_report,
                              random_profiles)
from repro_torch.fl import run_fl_experiment
from repro_torch.fl.simulation import SimConfig

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="where the rounds run (default: cuda)")
args = parser.parse_args()

# -- Stages 1 & 2 on virtual clients ---------------------------------------
rng = np.random.default_rng(0)
provider = FLServiceProvider(random_profiles(60, n_classes=10, rng=rng))
task = TaskRequest(budget=500.0, n_star=20, subset_size=8, subset_delta=2,
                   x_star=3)

pool = provider.select_pool(task, method="greedy")
print(f"Stage 1: selected {len(pool.selected)} clients, "
      f"score={pool.total_score:.1f}, cost={pool.total_cost:.0f}/<={task.budget:.0f}")

sched = provider.schedule_period(pool.selected, task, rng)
rep = fairness_report(sched, pool.selected, x_star=task.x_star)
print(f"Stage 2: {sched.num_rounds} subsets/period, max Nid={rep['max_nid']:.3f}, "
      f"coverage={rep['coverage']}, bounded={rep['bounded']}, "
      f"Jain={rep['jain_index']:.3f}")

# -- End-to-end federated training (tiny) -----------------------------------
out = run_fl_experiment(
    "mnist", "type1", n_clients=20, rounds=24, scheduler="mkp",
    n_train=2000, n_test=500, subset_size=5,
    sim=SimConfig(batch_size=16, local_steps=2, local_lr=0.15, eval_every=8),
    device=args.device)
accs = [h.get("accuracy") for h in out["history"] if "accuracy" in h]
print(f"FL training on {args.device}: {len(out['history'])} rounds, "
      f"accuracy trajectory={['%.2f' % a for a in accs]}, "
      f"final={out['final_accuracy']:.2f}")
