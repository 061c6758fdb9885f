"""Control plane of the port: the paper's client selection (stage 1)
and scheduling (stage 2), the task lifecycle and the service facade.

Host-side numpy, kept bit-identical to the JAX package's ``core``,
plus the device selection plane in torch:

- ``ClientPoolState`` (pool.py) is the struct-of-arrays client pool
  (scores ``(n, 11)``, histograms ``(n, c)``, costs, active mask,
  participation counts) shared by every stage.
- ``engine`` holds the vectorized stage-1 greedy knapsack (single,
  batched over tasks, and hierarchical over the sharded device mirror
  ``DevicePoolState`` of device_pool.py at fleet scale) and the Toyoda
  MKP scoring and its device greedy; ``selection`` / ``scheduling`` /
  ``mkp`` build the two stages on it, and ``policy`` is the by-name
  strategy registry (``paper_greedy`` + ``iid_subsets`` reproduce the
  paper).
- ``lifecycle`` is the explicit ``TaskState`` machine (``submit`` /
  ``dispatch`` / ``collect`` / ``drain``) with reputation updates from
  the quality cosines (``reputation``); ``service`` is the provider
  facade; ``placement`` maps tenants onto device indices.
- ``faults`` is the seeded counter-based fault plan (stragglers,
  crashes, departures, outages) that the lifecycle's fault mode reads
  from a trainer; ``workload`` / ``driver`` / ``telemetry`` are the
  online harness: arrival, availability and device-speed traces, a
  virtual-clock ``OnlineDriver`` replaying them against a live
  ``ServiceScheduler``, and SLA telemetry.
- ``lifecycle.save_state`` / ``load_state`` write and read a task's
  state (and, with ``trainer=``, its trainer's server state) through
  ``repro_torch.checkpoint``, in the JAX package's file format.
"""
from .criteria import (CRITERIA, NUM_CRITERIA, ClientProfile, build_profiles,
                       cosine_similarity, data_dist_score, linear_cost, nid,
                       nid_hellinger, nid_kl, nid_l2, overall_score,
                       random_histograms, random_profiles, resource_scores)
from .device_pool import DevicePoolState
from .fairness import (bounded_participation, coverage, fairness_report,
                       jain_index, over_selection_fraction)
from .faults import FaultPlan, RoundOutcome
from .lifecycle import (AsyncTrainer, InFlightError, PendingChunk,
                        RejectedTask, RoundEvent, ServiceScheduler,
                        ServiceState, TaskPhase, TaskState, Trainer,
                        apply_pool_selection, as_run_result, collect,
                        dispatch, drain, load_state, resolve_trainer,
                        save_state, single_round_adapter, step, submit)
from .mkp import MKPResult, solve_mkp, solve_mkp_bnb, solve_mkp_greedy
from .placement import (PlacementPolicy, available_placement_policies,
                        placement_policy, register_placement_policy,
                        resolve_placement_policy)
from .policy import (SchedulingPolicy, SelectionPolicy,
                     available_scheduling_policies,
                     available_selection_policies,
                     register_scheduling_policy, register_selection_policy,
                     resolve_scheduling_policy, resolve_selection_policy,
                     scheduling_policy, selection_policy)
from .pool import ClientPoolState
from .reputation import ReputationRecord, ReputationTracker, model_quality_batch
from .scheduling import (ScheduleResult, default_capacities,
                         default_capacities_arrays, generate_subsets,
                         generate_subsets_legacy, participation_weights,
                         random_subsets, subset_nid)
from .selection import (SelectionResult, budget_floor, select_dp,
                        select_greedy, select_greedy_legacy,
                        select_initial_pool, select_random,
                        select_score_prop, threshold_filter)
from .service import FLServiceProvider, RoundLog, ServiceRunResult, TaskRequest
from .workload import (ArrivalTrace, DeviceSpeedProfile, DiurnalAvailability,
                       HeterogeneousFaultPlan, WorkloadTrace, make_workload)
from .driver import OnlineDriver
from .telemetry import TelemetryEvent, TelemetryLog

__all__ = [
    "CRITERIA", "NUM_CRITERIA", "ClientPoolState", "ClientProfile",
    "build_profiles", "cosine_similarity", "data_dist_score", "linear_cost",
    "nid", "nid_hellinger", "nid_kl", "nid_l2", "overall_score",
    "random_histograms", "random_profiles", "resource_scores",
    "DevicePoolState", "bounded_participation", "coverage", "fairness_report", "jain_index",
    "over_selection_fraction", "MKPResult", "solve_mkp", "solve_mkp_bnb",
    "solve_mkp_greedy", "ReputationRecord", "ReputationTracker",
    "model_quality_batch", "ScheduleResult", "default_capacities",
    "default_capacities_arrays", "generate_subsets", "generate_subsets_legacy",
    "participation_weights", "random_subsets", "subset_nid",
    "SelectionResult", "budget_floor", "select_dp", "select_greedy",
    "select_greedy_legacy", "select_initial_pool", "select_random",
    "select_score_prop", "threshold_filter",
    "FLServiceProvider", "RoundLog", "ServiceRunResult", "TaskRequest",
    "SchedulingPolicy", "SelectionPolicy", "available_scheduling_policies",
    "available_selection_policies", "register_scheduling_policy",
    "register_selection_policy", "resolve_scheduling_policy",
    "resolve_selection_policy", "scheduling_policy", "selection_policy",
    "AsyncTrainer", "InFlightError", "PendingChunk", "RejectedTask",
    "RoundEvent", "ServiceScheduler", "ServiceState", "TaskPhase",
    "TaskState", "Trainer", "apply_pool_selection", "as_run_result",
    "collect", "dispatch", "drain", "load_state", "resolve_trainer",
    "save_state", "single_round_adapter", "step", "submit",
    "FaultPlan", "RoundOutcome",
    "ArrivalTrace", "DeviceSpeedProfile", "DiurnalAvailability",
    "HeterogeneousFaultPlan", "OnlineDriver", "TelemetryEvent",
    "TelemetryLog", "WorkloadTrace", "make_workload",
    "PlacementPolicy", "available_placement_policies", "placement_policy",
    "register_placement_policy", "resolve_placement_policy",
]
