"""Port parity for the fault plane: ``repro_torch.core.faults`` against
the JAX package's ``core.faults``, the arrival masks of the round plane,
the lifecycle's fault mode with stub trainers, and both CNN trainers
under a fault plan against the reference's.

The plan and the lifecycle are host-side numpy: draws, outcomes,
events, reputation arrays and pool counters are held equal, bit for
bit. The trainers train in f32 in another framework: arrivals, returned
masks, subsets and latencies are equal; losses are held to rtol 1e-4
and q-values to atol 1e-4 after a few rounds from the same parameters
(the bounds of tests/test_torch_slice.py).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import FaultPlan as RFaultPlan
from repro.core import FLServiceProvider as RProvider
from repro.core import TaskRequest as RTask
from repro.core import as_run_result as r_as_run_result
from repro.core import drain as r_drain
from repro.core import random_profiles as r_random_profiles
from repro.core import submit as r_submit
from repro.core.faults import _splitmix64 as r_splitmix64
from repro.core.faults import _u01 as r_u01
from repro.fl import simulation as ref_sim
from repro.models import cnn as jcnn
from repro_torch.core import (FaultPlan, FLServiceProvider, RoundOutcome,
                              TaskPhase, TaskRequest, as_run_result, drain,
                              random_profiles, submit)
from repro_torch.core.faults import _splitmix64, _u01
from repro_torch.fl import device_data, simulation
from repro_torch.models import cnn

PLAN_KW = dict(seed=11, straggler_frac=0.2, straggler_slowdown=8.0,
               crash_prob=0.05, permanent_frac=0.2, outage_prob=0.1,
               outage_len=5)
MITIGATED = dict(overschedule_factor=1.5, quorum_frac=0.6,
                 collect_deadline=2.0)


# ---------------------------------------------------------------------------
# FaultPlan: draws and round outcomes, bit for bit
# ---------------------------------------------------------------------------

def test_splitmix_and_u01_bit_identical():
    z = np.arange(0, 1 << 20, 977, dtype=np.uint64) * np.uint64(0x9E37)
    np.testing.assert_array_equal(_splitmix64(z.copy()),
                                  r_splitmix64(z.copy()))
    ids = np.arange(5000)
    for seed, stream, extra in ((0, 1, 0), (7, 2, 13), (123, 5, 999)):
        np.testing.assert_array_equal(_u01(seed, stream, ids, extra),
                                      r_u01(seed, stream, ids, extra))


@pytest.mark.parametrize("kw", [
    {}, PLAN_KW,
    dict(seed=3, straggler_frac=0.5, straggler_slowdown=50.0,
         latency_jitter=0.0),
    dict(seed=5, crash_prob=0.3, permanent_frac=1.0, outage_prob=0.4,
         outage_len=2, base_latency=2.5)])
def test_fault_plan_draws_bit_identical(kw):
    plan, ref = FaultPlan(**kw), RFaultPlan(**kw)
    assert plan.active == ref.active
    ids = np.arange(2000)
    np.testing.assert_array_equal(plan.is_straggler(ids),
                                  ref.is_straggler(ids))
    np.testing.assert_array_equal(plan.death_round(ids),
                                  ref.death_round(ids))
    for rnd in (0, 1, 7, 64, 1023):
        for name in ("latency", "crashed", "in_outage", "alive"):
            np.testing.assert_array_equal(getattr(plan, name)(ids, rnd),
                                          getattr(ref, name)(ids, rnd),
                                          err_msg=f"{name} round {rnd}")
    rng = np.random.default_rng(0)
    for rnd in range(40):
        members = rng.choice(2000, size=rng.integers(1, 30), replace=False)
        for deadline in (0.0, 1.1, 2.0):
            a = plan.round_outcome(members, rnd, deadline, target_k=5,
                                   quorum_k=3)
            b = ref.round_outcome(members, rnd, deadline, target_k=5,
                                  quorum_k=3)
            assert isinstance(a, RoundOutcome)
            np.testing.assert_array_equal(a.arrival, b.arrival)
            np.testing.assert_array_equal(a.latency, b.latency)
            assert (a.close_time, a.n_arrived, a.quorum_met) == \
                (b.close_time, b.n_arrived, b.quorum_met)


# ---------------------------------------------------------------------------
# dropout_mask(arrival=), as tests/test_faults.py::TestArrivalMask
# ---------------------------------------------------------------------------

def test_dropout_mask_default_path_unchanged():
    mask_u = torch.as_tensor(np.linspace(0.0, 1.0, 8), dtype=torch.float32)
    a = device_data.dropout_mask(mask_u, torch.ones(8), 0.3)
    b = device_data.dropout_mask(mask_u, torch.ones(8), 0.3, arrival=None)
    assert torch.equal(a, b)


def test_dropout_mask_arrival_masks_and_falls_back():
    import jax.numpy as jnp
    from repro.fl import device_data as ref_dd
    arrival = np.array([0.0, 0.0, 1.0, 1.0, 0.0, 1.0], np.float32)
    for mask_u, rate in ((np.full(6, 0.9, np.float32), 0.0),
                         (np.zeros(6, np.float32), 0.5)):
        for active in (np.ones(6, np.float32),
                       np.array([1, 1, 0, 1, 1, 0], np.float32),
                       np.zeros(6, np.float32)):
            got = device_data.dropout_mask(
                torch.as_tensor(mask_u), torch.as_tensor(active), rate,
                arrival=torch.as_tensor(arrival)).numpy()
            exp = np.asarray(ref_dd.dropout_mask(
                jnp.asarray(mask_u), jnp.asarray(active), rate,
                arrival=jnp.asarray(arrival)))
            np.testing.assert_array_equal(got, exp)
    out = device_data.dropout_mask(torch.full((6,), 0.9), torch.ones(6), 0.0,
                                   arrival=torch.as_tensor(arrival))
    np.testing.assert_array_equal(out.numpy(), arrival)
    # all-drop: the fallback is the first arrived slot, not slot 0
    out = device_data.dropout_mask(torch.zeros(6), torch.ones(6), 0.5,
                                   arrival=torch.as_tensor(arrival))
    np.testing.assert_array_equal(out.numpy(), [0, 0, 1, 0, 0, 0])


# ---------------------------------------------------------------------------
# The lifecycle's fault mode with stub trainers
# ---------------------------------------------------------------------------

def _round_result(rnd, subset, fail_mod=7):
    subset = np.asarray(subset)
    returned = (subset + rnd) % fail_mod != 0
    q = np.where(returned, 0.5 + 0.4 * np.cos(subset + rnd), 0.0)
    return returned, q, {"round": rnd, "loss": 1.0 / (rnd + 1)}


class FaultyChunkStub:
    """A sync trainer carrying a fault plan, as the reference's test
    stub: arrival-aware, and it ignores the masks (the lifecycle's host
    side masking is what is compared)."""

    accepts_arrivals = True

    def __init__(self, fault_plan=None):
        self.fault_plan = fault_plan

    def run_rounds(self, start_round, subsets, weights, arrivals=None):
        return [_round_result(start_round + j, s)
                for j, s in enumerate(subsets)]


def _events(events):
    return [(e.period, e.round_index, tuple(e.subset),
             tuple(np.asarray(e.weights).tolist()), e.nid, e.metrics)
            for e in events]


def _drain_both(plan_kw, **task_kw):
    base = dict(budget=400.0, n_star=10, subset_size=5, subset_delta=2,
                max_periods=3, seed=3)
    base.update(task_kw)
    out = []
    for Provider, Task, profiles, sub, dr, Plan in (
            (FLServiceProvider, TaskRequest, random_profiles, submit, drain,
             FaultPlan),
            (RProvider, RTask, r_random_profiles, r_submit, r_drain,
             RFaultPlan)):
        sp = Provider(profiles(60, 10, np.random.default_rng(0)))
        plan = None if plan_kw is None else Plan(**plan_kw)
        state = sub(sp, Task(**base))
        state, events = dr(sp, state, FaultyChunkStub(fault_plan=plan))
        out.append((sp, state, events))
    return out


@pytest.mark.parametrize("plan_kw,task_kw", [
    (PLAN_KW, MITIGATED),
    (dict(seed=11, straggler_frac=0.5, straggler_slowdown=50.0,
          latency_jitter=0.0), dict(MITIGATED, max_periods=1)),
    (dict(seed=0, crash_prob=1.0), dict(quorum_frac=0.5,
                                         collect_deadline=2.0, max_retries=2,
                                         retry_backoff=1.0)),
    (None, {})])
def test_lifecycle_fault_mode_matches_reference(plan_kw, task_kw):
    (sp, st, ev), (rsp, rst, rev) = _drain_both(plan_kw, **task_kw)
    assert st.phase.name == rst.phase.name
    assert _events(ev) == _events(rev)
    assert (st.retry_count, st.retry_latency) == \
        (rst.retry_count, rst.retry_latency)
    ta, tb = st.tracker.to_arrays(), rst.tracker.to_arrays()
    assert sorted(ta) == sorted(tb)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    np.testing.assert_array_equal(sp.pool_state.dispatch_counts,
                                  rsp.pool_state.dispatch_counts)
    np.testing.assert_array_equal(sp.pool_state.timeout_counts,
                                  rsp.pool_state.timeout_counts)
    if plan_kw is not None and plan_kw.get("crash_prob") == 1.0:
        assert st.phase == TaskPhase.DEGRADED and ev == []
    elif plan_kw is not None:
        assert any("round_latency" in e.metrics for e in ev)


def test_inactive_plan_takes_the_no_fault_path():
    a = _drain_both(None)[0]
    b = _drain_both({})[0]
    assert _events(a[2]) == _events(b[2])
    assert all("round_latency" not in e.metrics for e in b[2])


# ---------------------------------------------------------------------------
# Both trainers under a fault plan, against the reference's
# ---------------------------------------------------------------------------

SIM_KW = dict(dropout_rate=0.2, eval_every=2, batch_size=8)
RUN = dict(n_clients=12, rounds=5, n_train=600, n_test=200, subset_size=4,
           subset_delta=1, seed=0, overschedule_factor=1.5, quorum_frac=0.5,
           collect_deadline=2.0)
SIM_PLAN = dict(seed=7, straggler_frac=0.3, straggler_slowdown=8.0,
                crash_prob=0.1, outage_prob=0.1, outage_len=3)


@pytest.fixture
def reference_init(monkeypatch):
    """The port's trainers start from the reference's initial params
    (the seed's ``jax.random`` draws, carried across as numpy)."""
    def init(cfg, generator, device=None):
        jcfg = {c.name: c for c in (jcnn.MNIST_CNN, jcnn.CIFAR_CNN)}[cfg.name]
        tree = jcnn.init_params(jcfg,
                                jax.random.PRNGKey(generator.initial_seed()))
        params = cnn.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        return {k: v.to(device) for k, v in params.items()}
    monkeypatch.setattr(cnn, "init_params", init)


@pytest.mark.parametrize("plane", ["host", "device"])
def test_sims_under_a_plan_match_reference(plane, reference_init):
    kw = dict(RUN, data_plane=plane, round_chunk=3)
    port = simulation.run_fl_experiment(
        "mnist", "type2", sim=simulation.SimConfig(**SIM_KW),
        fault_plan=FaultPlan(**SIM_PLAN), device="cpu", **kw)
    ref = ref_sim.run_fl_experiment(
        "mnist", "type2", sim=ref_sim.SimConfig(**SIM_KW),
        fault_plan=RFaultPlan(**SIM_PLAN), **kw)
    ps, rs = port["state"], ref["state"]
    assert len(ps.rounds) == len(rs.rounds) == RUN["rounds"]
    late = 0
    for a, b in zip(ps.rounds, rs.rounds):
        assert (a.period, a.round_index, a.subset) == \
            (b.period, b.round_index, b.subset)
        for key in ("n_scheduled", "n_arrived", "round_latency"):
            assert a.metrics[key] == b.metrics[key], key
        late += a.metrics["n_scheduled"] - a.metrics["n_arrived"]
        np.testing.assert_allclose(a.metrics["loss"], b.metrics["loss"],
                                   rtol=1e-4)
    assert late > 0, "no client missed a close; the test is vacuous"
    ta, tb = ps.tracker.to_arrays(), rs.tracker.to_arrays()
    for k in ta:
        if k == "q":
            np.testing.assert_allclose(ta[k], tb[k], atol=1e-4)
        else:                   # ids, returned masks (b_t), counts
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


@pytest.mark.parametrize("plane", ["host", "device"])
def test_inactive_plan_is_no_plan_bit_for_bit(plane):
    kw = dict(RUN, rounds=4, data_plane=plane, round_chunk=2)
    runs = [simulation.run_fl_experiment(
        "mnist", "type2", sim=simulation.SimConfig(**SIM_KW),
        fault_plan=plan, device="cpu", **kw) for plan in (None, FaultPlan())]
    (a, b) = runs
    assert a["history"] == b["history"]
    assert a["final_accuracy"] == b["final_accuracy"]
    assert _events(a["state"].rounds) == _events(b["state"].rounds)
    ta, tb = (r["state"].tracker.to_arrays() for r in runs)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def test_non_arrived_clients_get_no_weight_or_quality(reference_init):
    """A client that missed the close trains (its slot is in the batch)
    but the mask zeroes it: its q is 0 and its b_t is 0, on both
    planes, round for round."""
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.fl.partition import partition_labels
    data = make_classification_data("mnist", 400, seed=1)
    parts = partition_labels(data.labels, 8, "type2", 10, seed=1)
    sim = simulation.SimConfig(dropout_rate=0.0, batch_size=8, eval_every=99)
    subset, w = [0, 2, 5, 7], np.full(4, 0.25)
    arrival = np.array([True, False, True, False])
    host = simulation.FLClassificationSim(cnn.MNIST_CNN, data, parts, data,
                                          sim, device="cpu")
    dev = simulation.DeviceFLSim(cnn.MNIST_CNN, data, parts, data, sim,
                                 device="cpu")
    out_h = host.run_rounds(3, [subset], [w], arrivals=[arrival])[0]
    out_d = dev.run_rounds(3, [subset], [w], arrivals=[arrival])[0]
    for returned, q, _ in (out_h, out_d):
        np.testing.assert_array_equal(returned, arrival)
        assert (q[~arrival] == 0).all() and (q[arrival] != 0).all()
    np.testing.assert_allclose(out_h[1], out_d[1], atol=1e-4)
