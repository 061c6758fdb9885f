"""Port parity: the control plane (stage 1, stage 2, fairness) of
``repro_torch.core`` against the JAX package's ``repro.core``.

Both are host-side numpy and the port keeps copies of the reference's
modules, so every output is compared for exact equality: same pools,
same schedules, same reports, bit for bit.
"""
import numpy as np
import pytest

from repro.core import ClientPoolState as RefPool
from repro.core import FLServiceProvider as RefProvider
from repro.core import TaskRequest as RefTask
from repro.core import fairness as ref_fairness
from repro.core import policy as ref_policy
from repro_torch.core import ClientPoolState, FLServiceProvider, TaskRequest
from repro_torch.core import fairness, policy

POOL_KINDS = [(60, 10, 0), (150, 4, 1), (400, 10, 2)]


def pools(n, c, seed):
    """The same random pool in both packages (same numpy draws)."""
    ref = RefPool.random(n, c, np.random.default_rng(seed))
    port = ClientPoolState.random(n, c, np.random.default_rng(seed))
    np.testing.assert_array_equal(ref.scores, port.scores)
    np.testing.assert_array_equal(ref.histograms, port.histograms)
    np.testing.assert_array_equal(ref.costs, port.costs)
    return ref, port


def assert_same_schedule(a, b):
    assert a.subsets == b.subsets
    assert a.counts == b.counts
    np.testing.assert_array_equal(np.asarray(a.nids), np.asarray(b.nids))
    np.testing.assert_array_equal(a.capacities, b.capacities)


def test_registries_match():
    assert policy.available_selection_policies() == \
        ref_policy.available_selection_policies()
    assert policy.available_scheduling_policies() == \
        ref_policy.available_scheduling_policies()


@pytest.mark.parametrize("n,c,seed", POOL_KINDS)
@pytest.mark.parametrize("name", ["paper_greedy", "dp", "random",
                                  "score_prop", "straggler_aware"])
@pytest.mark.parametrize("budget_frac", [0.2, 10.0])
def test_select_pool_identical(n, c, seed, name, budget_frac):
    ref, port = pools(n, c, seed)
    budget = float(budget_frac * ref.costs.sum() / 4)
    kw = dict(budget=budget, n_star=3, selection_policy=name, seed=seed)
    a = RefProvider(ref).select_pool(RefTask(**kw),
                                     rng=np.random.default_rng(seed))
    b = FLServiceProvider(port).select_pool(TaskRequest(**kw),
                                            rng=np.random.default_rng(seed))
    assert a.selected == b.selected
    assert a.total_score == b.total_score
    assert a.total_cost == b.total_cost
    assert a.feasible == b.feasible and a.note == b.note


@pytest.mark.parametrize("n,c,seed", POOL_KINDS)
@pytest.mark.parametrize("name", ["iid_subsets", "random_partition",
                                  "fair_ema", "deadline_aware"])
def test_schedule_period_identical(n, c, seed, name):
    ref, port = pools(n, c, seed)
    ids = list(range(0, n, 2))
    kw = dict(budget=1e9, subset_size=10, subset_delta=3, x_star=3,
              scheduling_policy=name, seed=seed)
    st_a, st_b = {}, {}
    for _ in range(2):                 # stateful policies: two periods
        a = RefProvider(ref).schedule_period(
            ids, RefTask(**kw), np.random.default_rng(seed), st_a)
        b = FLServiceProvider(port).schedule_period(
            ids, TaskRequest(**kw), np.random.default_rng(seed), st_b)
        assert_same_schedule(a, b)
    assert sorted(st_a) == sorted(st_b)
    for k in st_a:
        np.testing.assert_array_equal(st_a[k], st_b[k])
    rep_a = ref_fairness.fairness_report(a, ids, x_star=3)
    rep_b = fairness.fairness_report(b, ids, x_star=3)
    assert rep_a == rep_b


@pytest.mark.parametrize("n,c,seed", POOL_KINDS)
def test_iid_subsets_section_vii_guarantees(n, c, seed):
    """Coverage, bounded participation (x*) and subset sizes n±δ."""
    _, port = pools(n, c, seed)
    ids = list(range(n))
    nn, delta, x_star = 10, 3, 3
    res = FLServiceProvider(port).schedule_period(
        ids, TaskRequest(budget=1e9, subset_size=nn, subset_delta=delta,
                         x_star=x_star), np.random.default_rng(seed))
    rep = fairness.fairness_report(res, ids, x_star=x_star)
    assert rep["coverage"] and rep["bounded"]
    assert 0.0 < rep["jain_index"] <= 1.0
    seen = set()
    for i, s in enumerate(res.subsets):
        assert len(s) == len(set(s)) and len(s) <= nn + delta
        if i < len(res.subsets) - 1:
            assert len(s) >= nn - delta
        else:
            assert len(s) >= min(nn - delta, n - len(seen))
        seen |= set(s)
    assert seen == set(ids)
