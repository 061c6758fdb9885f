"""FL-service walkthrough on the PyTorch port: the full §III system
loop as an explicit, resumable task lifecycle.

Demonstrates the redesigned service API end to end:

1. task intake -> threshold filter + budget floor (Eq. 11) -> greedy
   pool selection (``lifecycle.submit``);
2. stepping the task state machine one transition at a time
   (``lifecycle.step``: SCHEDULED -> TRAINING -> PERIOD_CHECKPOINT),
   with per-round model-quality/behavior tracking (Eqs. 3-5) and
   suspension of unreliable clients;
3. client churn: new clients register into the shared pool mid-task and
   are admitted at the next PERIOD_CHECKPOINT; a departing client is
   deregistered and dropped;
4. checkpoint/resume: the TaskState is serialized to disk mid-period,
   "the provider dies", and a fresh provider resumes it to completion
   (``lifecycle.save_state`` / ``load_state``); then the same with a
   model: the federated LoRA LM task (fl.transformer_task, reduced
   SmolLM-360M) on ``--device`` is checkpointed mid-period with its
   trainer's server state, resumed in a fresh trainer, and its rounds
   and adapters are held to an uninterrupted run bit for bit;
5. multi-tenant serving: a ServiceScheduler drives several tasks
   concurrently over the one shared pool with batched stage-1 intake
   and the overlapped dispatch/collect pump (docs/service_api.md);
6. policy A/B (docs/policies.md): the paper's selection/scheduling
   pair vs the ``--selection-policy`` / ``--scheduling-policy``
   challenger (default: the random baselines) on the same pool with
   the same seed — pool quality, accuracy proxy, Jain fairness;
7. (with ``--workload``) the online harness (docs/workloads.md): a
   seeded trace replayed through the virtual-clock ``OnlineDriver``
   against a fresh scheduler, closing with the SLA telemetry table
   (p50/p99 round latency, queue wait, completion, Jain fairness).

Run:  PYTHONPATH=src python examples/fl_service_demo_torch.py [--device cpu]
      PYTHONPATH=src python examples/fl_service_demo_torch.py \\
          --selection-policy score_prop --scheduling-policy fair_ema
      PYTHONPATH=src python examples/fl_service_demo_torch.py --workload bursty
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import (FLServiceProvider, OnlineDriver, ServiceScheduler,
                        TaskPhase, TaskRequest, as_run_result,
                        available_scheduling_policies,
                        available_selection_policies, budget_floor, drain,
                        jain_index, load_state, make_workload,
                        random_profiles, save_state, step, submit,
                        threshold_filter)
from repro_torch.core.lifecycle import restore_trainer_state
from repro_torch.core.pool import ClientPoolState
from repro_torch.fl.transformer_task import make_transformer_fl

parser = argparse.ArgumentParser(
    description="FL-service lifecycle walkthrough + policy A/B")
parser.add_argument("--selection-policy", default="random",
                    choices=available_selection_policies(),
                    help="stage-1 challenger for the A/B vs the paper's "
                         "greedy (default: random)")
parser.add_argument("--scheduling-policy", default="random_partition",
                    choices=available_scheduling_policies(),
                    help="stage-2 challenger for the A/B vs the paper's "
                         "Algorithm 1 (default: random_partition)")
parser.add_argument("--workload", default=None,
                    choices=("steady", "bursty", "diurnal"),
                    help="also replay this workload regime through the "
                         "OnlineDriver and print the SLA summary "
                         "(docs/workloads.md)")
parser.add_argument("--device", default="cuda",
                    help="where the LM task's rounds run (default: cuda)")
args = parser.parse_args()

rng = np.random.default_rng(7)
profiles = random_profiles(80, n_classes=10, rng=rng)
provider = FLServiceProvider(profiles)

thresholds = np.full(9, 0.05)
filtered = threshold_filter(profiles, thresholds)
floor = budget_floor(filtered, n_star=20)
print(f"{len(filtered)}/{len(profiles)} clients pass thresholds; "
      f"Eq.(11) budget floor for n*=20: {floor:.0f}")

task = TaskRequest(budget=floor * 1.2, n_star=20, thresholds=thresholds,
                   subset_size=6, subset_delta=2, x_star=3, max_periods=3,
                   rep_threshold=0.6, suspension_periods=1)

# a trainer stub where five clients are chronically unreliable
flaky = set(p.client_id for p in profiles[:5])


def trainer(rnd, subset, weights):
    returned = np.array([not (c in flaky and rng.uniform() < 0.8)
                         for c in subset])
    q = np.where(returned, rng.uniform(0.6, 0.95, len(subset)), 0.0)
    return returned, q, {"round": rnd}


# -- 1-2: submit, then step the machine explicitly --------------------------
state = submit(provider, task)
print(f"\nsubmit -> {state.phase.name}: pool of "
      f"{len(state.pool_selected.selected)} clients, cost "
      f"{state.pool_selected.total_cost:.0f} <= {task.budget:.0f}")

transitions = 0
while not (state.phase == TaskPhase.PERIOD_CHECKPOINT
           or state.phase.terminal):
    state, events = step(provider, state, trainer)
    transitions += 1
    if events:
        print(f"  step {transitions}: {state.phase.name:17s} trained rounds "
              f"{[e.round_index for e in events]}")
    else:
        print(f"  step {transitions}: -> {state.phase.name}")

# -- 3: churn between periods ------------------------------------------------
# three budget-priced newcomers join the shared pool mid-task; whoever
# fits the task's remaining stage-1 budget is admitted at the checkpoint
joiners = ClientPoolState.random(3, 10, np.random.default_rng(99))
provider.pool_state.register_arrays(joiners.client_ids + 1000,
                                    joiners.scores, joiners.histograms,
                                    np.full(3, 5.0))
leaver = sorted(state.pool)[-1]
provider.pool_state.deregister([leaver])
state, _ = step(provider, state, trainer)   # the PERIOD_CHECKPOINT step
admitted = sorted(set(state.admitted))
print(f"\nchurn at period boundary: registered 3 joiners, deregistered "
      f"client {leaver}; admitted {admitted}, pool now {len(state.pool)}")

# -- 4: checkpoint, "crash", resume in a fresh provider ----------------------
# step into the middle of period 1 (schedule drawn, one chunk trained)
# so the checkpoint carries a pending schedule and a subset cursor
state, _ = step(provider, state, trainer)   # -> SCHEDULED
state, _ = step(provider, state, trainer)   # -> TRAINING (1 round done)
ckpt = os.path.join(tempfile.mkdtemp(), "task_state.ckpt")
save_state(ckpt, state)
pool_arrays = provider.pool_state          # the registry survives the crash
del provider, state

provider = FLServiceProvider(pool_arrays)
state = load_state(ckpt)
print(f"resumed from {os.path.basename(ckpt)} at phase {state.phase.name}, "
      f"period {state.period}, round {state.global_round} "
      f"(subset {state.subset_index}/{len(state.schedule.subsets)} of the "
      f"pending schedule)")
state, events = drain(provider, state, trainer)
result = as_run_result(state)
print(f"drained to {state.phase.name}: {len(events)} further rounds")

for period in sorted({e.period for e in result.rounds}):
    rounds = [r for r in result.rounds if r.period == period]
    participants = {c for r in rounds for c in r.subset}
    print(f"period {period}: {len(rounds)} rounds, "
          f"{len(participants)} distinct clients, "
          f"flaky present: {len(participants & flaky)}")
low = [cid for cid, s in result.reputation.items() if s < 1.2]
print(f"low-reputation clients (s_rep < 1.2): {sorted(low)[:10]} "
      f"(flaky = {sorted(flaky)})")

# -- 4b: the same with a model: the federated LM task ----------------------
# an uninterrupted run of 4 rounds, then a run checkpointed after round
# 2 with the trainer's server state (the LoRA adapters), "crashed" and
# resumed in a fresh trainer: rounds and adapters must agree bit for bit

def lm_bundle():
    return make_transformer_fl(n_clients=10, n_train=100, n_test=30,
                               seq_len=8, device=args.device)


def lm_task():
    return TaskRequest(budget=200.0, subset_size=4, subset_delta=2, x_star=2,
                       max_periods=3, max_rounds=4, round_chunk=1, seed=0)


ref = lm_bundle()
lm_sp = FLServiceProvider(ref["pool"])
lm_state, lm_ref = drain(lm_sp, submit(lm_sp, lm_task()), ref["trainer"])

first = lm_bundle()
lm_sp = FLServiceProvider(first["pool"])
lm_state, lm_events = submit(lm_sp, lm_task()), []
while len(lm_events) < 2:
    lm_state, ev = step(lm_sp, lm_state, first["trainer"])
    lm_events += ev
lm_ckpt = os.path.join(tempfile.mkdtemp(), "lm_task_state.ckpt")
lm_events += save_state(lm_ckpt, lm_state, flush=True,
                        trainer=first["trainer"])
del first, lm_state

fresh = lm_bundle()
lm_state = load_state(lm_ckpt)
assert restore_trainer_state(lm_state, fresh["trainer"])
lm_sp = FLServiceProvider(fresh["pool"])
lm_state, ev = drain(lm_sp, lm_state, fresh["trainer"])
lm_events += ev
same_rounds = [(e.period, e.round_index, list(e.subset), e.nid)
               for e in lm_events] == [(e.period, e.round_index,
                                        list(e.subset), e.nid)
                                       for e in lm_ref]
same_adapters = all(torch.equal(ref["trainer"].params[k],
                                fresh["trainer"].params[k])
                    for k in ref["trainer"].params)
print(f"\nLM task on {args.device}: resumed after round 2 from "
      f"{os.path.basename(lm_ckpt)} ({os.path.getsize(lm_ckpt)} bytes, "
      f"{len(lm_state.trainer_state)} trainer arrays); {len(lm_events)} "
      f"rounds, rounds equal: {same_rounds}, adapters equal: "
      f"{same_adapters}")
if not (same_rounds and same_adapters):
    raise SystemExit("the resumed LM task left the uninterrupted run")

# -- 5: multi-tenant serving -------------------------------------------------
scheduler = ServiceScheduler(provider)
for i in range(4):
    t = TaskRequest(budget=floor * (0.8 + 0.2 * i), n_star=10,
                    thresholds=thresholds, subset_size=5, subset_delta=2,
                    max_periods=2, seed=i)
    scheduler.submit(t, trainer)
results = scheduler.run()
print(f"\nServiceScheduler served {len(results)} concurrent tasks "
      f"(batched stage-1 intake, overlapped dispatch/collect pump):")
for tid, res in results.items():
    print(f"  task {tid}: {res.num_rounds:2d} rounds over "
          f"{len(res.schedules)} periods, pool {len(res.pool.selected)}")

# -- 6: policy A/B on the same pool ------------------------------------------
# the paper's pair vs the flagged challenger: same profiles, same seed,
# same (binding) budget — only TaskRequest.selection_policy /
# scheduling_policy differ (docs/policies.md)
arms = {
    "paper": ("paper_greedy", "iid_subsets"),
    "challenger": (args.selection_policy, args.scheduling_policy),
}
ab_budget = floor * 0.6                      # binding: arms pick real pools
print(f"\npolicy A/B on the same pool (budget {ab_budget:.0f}):")
for arm, (sel, sch) in arms.items():
    sp = FLServiceProvider(random_profiles(80, n_classes=10,
                                           rng=np.random.default_rng(7)))
    # each arm gets its own identically-seeded trainer rng, so the
    # stochastic client behaviour is the same stream in both arms and
    # the printed differences are policy effect, not draw noise
    arm_rng = np.random.default_rng(1234)

    def arm_trainer(rnd, subset, weights):
        returned = np.array([not (c in flaky and arm_rng.uniform() < 0.8)
                             for c in subset])
        q = np.where(returned, arm_rng.uniform(0.6, 0.95, len(subset)), 0.0)
        return returned, q, {"round": rnd}

    t = TaskRequest(budget=ab_budget, n_star=5, thresholds=thresholds,
                    subset_size=6, subset_delta=2, max_periods=3, seed=42,
                    selection_policy=sel, scheduling_policy=sch)
    st = submit(sp, t)
    st, _ = drain(sp, st, arm_trainer)
    res = as_run_result(st)
    counts: dict[int, int] = {}
    for r in res.rounds:
        for c in r.subset:
            counts[c] = counts.get(c, 0) + 1
    jain = jain_index(np.array(sorted(counts.values()), dtype=np.float64))
    print(f"  {arm:10s} ({sel} + {sch}): pool {len(res.pool.selected):2d} "
          f"(score {res.pool.total_score:6.2f}, cost "
          f"{res.pool.total_cost:5.0f}), {res.num_rounds:2d} rounds, "
          f"Jain fairness {jain:.3f}, mean reputation "
          f"{np.mean(list(res.reputation.values())):.2f}")

# -- 7: online workload replay (--workload) ----------------------------------
# a seeded trace (docs/workloads.md) replayed through the virtual-clock
# OnlineDriver against a fresh scheduler: arrivals submitted at their
# trace times, RejectedTask backpressure requeued with backoff, the
# availability wave (diurnal) tick'd into period checkpoints, and the
# SLA telemetry table printed at the end
if args.workload is not None:
    class ChunkStub:
        """Deterministic sync chunk trainer for the workload replay;
        the trace's fault plan is attached by the OnlineDriver."""

        accepts_arrivals = True

        def __init__(self):
            self.fault_plan = None

        def run_rounds(self, start_round, subsets, weights, arrivals=None):
            out = []
            for j, s in enumerate(subsets):
                s = np.asarray(s)
                returned = (s + start_round + j) % 7 != 0
                q = np.where(returned,
                             0.5 + 0.4 * np.cos(s + start_round + j), 0.0)
                out.append((returned, q, {"round": start_round + j}))
            return out

    wp = FLServiceProvider(random_profiles(60, n_classes=10,
                                           rng=np.random.default_rng(11)))
    w_budget = float(np.round(0.5 * wp.pool_state.costs.sum()))

    def w_template(i, t):
        return TaskRequest(budget=w_budget, n_star=8, subset_size=8,
                           subset_delta=2, max_periods=2, max_rounds=4,
                           round_chunk=2, seed=i,
                           **({} if args.workload == "steady" else
                              dict(scheduling_policy="deadline_aware",
                                   overschedule_factor=1.5, quorum_frac=0.5,
                                   collect_deadline=3.0)))

    trace = make_workload(args.workload, seed=5, template=w_template,
                          horizon=32.0)
    online = OnlineDriver(ServiceScheduler(wp, max_inflight=4, max_queue=3),
                          trace, ChunkStub, backoff=1.0)
    # the steady regime has no trace arrivals — everything lands at t=0
    initial = ([w_template(i, 0.0) for i in range(4)]
               if args.workload == "steady" else None)
    online.run(initial_tasks=initial)
    summary = online.telemetry.summary()
    print(f"\n--workload {args.workload}: {summary['tasks_submitted']} tasks "
          f"over {summary['makespan']:.1f} sim time units, "
          f"{summary['rejects']} backpressure rejects, terminal phases "
          f"{sorted(set(online.phases.values()))}")
    print(online.telemetry.format_summary())
