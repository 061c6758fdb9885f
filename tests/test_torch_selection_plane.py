"""Port parity: the device selection plane of ``repro_torch.core`` against
the JAX package's ``repro.core``, on the CPU at small sizes.

- the sharded pool mirror (``device_pool.DevicePoolState``): layout,
  incremental sync after random churn, growth by whole shards, restage
  after a pruned log and no-op sync, array for array against the
  reference's mirror (both hold f32 copies of the same host columns:
  exact);
- the hierarchical two-level greedy: same rows, totals, ``n_valid`` and
  stats as the reference's and the same picks as the flat greedy
  (exact: the merge is host numpy and the frontier is the same f32
  ordering), and the routes of ``select_initial_pool`` /
  ``select_pools_batch`` above ``HIERARCHICAL_MIN_N``;
- the batched multi-task greedy: the numpy backend bit-exact, the
  device backend (on the CPU) with the same masks as the reference's
  ``backend="jax"`` on integer-cost pools, where f32 sums are exact;
- stage 2's device MKP greedy and ``generate_subsets(backend="device")``
  against the reference's ``backend="jax"`` (same f32 arithmetic; the
  instances have distinct utilities, so no f32 tie decides a pick), and
  the greedy kernel's plain version (``kernels.ref.mkp_greedy_ref``)
  against ``solve_mkp_greedy_jax`` on exact ties, NaN and +inf
  utilities, no item fitting, n = 1 and ``max_size`` None or past n;
- ``ServiceScheduler`` intake of several tasks, as the reference's.
"""
import numpy as np
import pytest
import torch

from repro.core import FLServiceProvider as RefProvider
from repro.core import ServiceScheduler as RefScheduler
from repro.core import TaskRequest as RefTask
from repro.core import device_pool as ref_device_pool
from repro.core import drain as ref_drain
from repro.core import engine as ref_engine
from repro.core import fairness as ref_fairness
from repro.core import mkp as ref_mkp
from repro.core import scheduling as ref_scheduling
from repro.core import selection as ref_selection
from repro.core import submit as ref_submit
from repro.core.criteria import random_histograms as ref_random_histograms
from repro.core.criteria import random_profiles as ref_random_profiles
from repro.core.pool import ClientPoolState as RefPool
from repro.kernels import ref as ref_kernels_ref
from repro_torch.core import (DevicePoolState, FLServiceProvider,
                              ServiceScheduler, TaskRequest, device_pool,
                              drain, engine, fairness, mkp, scheduling,
                              selection, submit)
from repro_torch.core.criteria import random_histograms, random_profiles
from repro_torch.core.pool import ClientPoolState
from repro_torch.kernels import ops
from repro_torch.kernels import ref as ref_kernels

TH = np.full(9, 0.05)
CPU = "cpu"


def pools(n, seed):
    """The same random pool in both packages (same numpy draws)."""
    return (RefPool.random(n, 10, np.random.default_rng(seed)),
            ClientPoolState.random(n, 10, np.random.default_rng(seed)))


def churn(pool, rng, n_events, histograms):
    """Random deregister/register mix (mutates pool)."""
    drop = rng.choice(pool.client_ids[pool.registered], size=n_events // 2,
                      replace=False)
    pool.deregister(drop)
    k = n_events - drop.size
    base = int(pool.client_ids.max()) + 1
    pool.register_arrays(np.arange(base, base + k), rng.random((k, 11)),
                         histograms(k, 10, rng), rng.uniform(1.0, 5.0, k))


def churn_both(ref, port, seed, n_events):
    churn(ref, np.random.default_rng(seed), n_events, ref_random_histograms)
    churn(port, np.random.default_rng(seed), n_events, random_histograms)


def assert_mirrors_equal(ref_m, port_m):
    assert port_m.num_shards == ref_m.num_shards
    assert port_m.n_rows == ref_m.n_rows
    assert port_m.synced_version == ref_m.synced_version
    assert (port_m.syncs, port_m.restages) == (ref_m.syncs, ref_m.restages)
    for attr in ("overall", "costs", "th_scores", "registered"):
        np.testing.assert_array_equal(getattr(port_m, attr).numpy(),
                                      np.asarray(getattr(ref_m, attr)),
                                      err_msg=attr)


# ---------------------------------------------------------------------------
# the sharded mirror
# ---------------------------------------------------------------------------

class TestMirror:
    def test_from_host_layout(self):
        ref, port = pools(1000, 0)
        m = DevicePoolState.from_host(port, shard_cap=256, device=CPU)
        assert m.num_shards == 4 and m.capacity == 1024
        assert m.device == torch.device(CPU)
        assert_mirrors_equal(
            ref_device_pool.DevicePoolState.from_host(ref, shard_cap=256), m)
        reg = m.registered.reshape(-1).numpy()
        assert reg[:1000].all() and not reg[1000:].any()

    def test_incremental_sync_after_random_churn(self):
        ref, port = pools(2000, 3)
        rm = ref.device_mirror(shard_cap=512)
        pm = port.device_mirror(shard_cap=512, device=CPU)
        rng = np.random.default_rng(7)
        for i in range(5):
            churn_both(ref, port, 100 + i, int(rng.integers(10, 120)))
            assert ref.device_mirror(shard_cap=512) is rm
            assert port.device_mirror(shard_cap=512) is pm   # cached, synced
            assert_mirrors_equal(rm, pm)
        assert pm.restages == 1 and pm.syncs == 5

    def test_growth_appends_shards(self):
        ref, port = pools(500, 1)
        rm = ref.device_mirror(shard_cap=256)
        pm = port.device_mirror(shard_cap=256, device=CPU)
        churn_both(ref, port, 2, 4)
        big = 900
        for p, hist in ((ref, ref_random_histograms),
                        (port, random_histograms)):
            r = np.random.default_rng(5)
            base = int(p.client_ids.max()) + 1
            p.register_arrays(np.arange(base, base + big), r.random((big, 11)),
                              hist(big, 10, r), r.uniform(1, 5, big))
        assert ref.device_mirror(shard_cap=256) is rm
        assert port.device_mirror(shard_cap=256) is pm
        assert pm.num_shards >= -(-port.n // 256)
        assert_mirrors_equal(rm, pm)

    def test_pruned_log_forces_restage(self, monkeypatch):
        ref, port = pools(300, 4)
        rm = ref.device_mirror(shard_cap=128)
        pm = port.device_mirror(shard_cap=128, device=CPU)
        monkeypatch.setattr(RefPool, "_MUTLOG_MAX", 4)
        monkeypatch.setattr(ClientPoolState, "_MUTLOG_MAX", 4)
        for i in range(10):                      # overflow the log
            churn_both(ref, port, 200 + i, 6)
        assert port.dirty_rows_since(pm.synced_version) is None
        assert ref.device_mirror(shard_cap=128) is rm
        assert port.device_mirror(shard_cap=128) is pm
        assert pm.restages == 2
        assert_mirrors_equal(rm, pm)

    def test_noop_sync_when_clean(self):
        _, port = pools(100, 0)
        m = port.device_mirror(shard_cap=64, device=CPU)
        assert port.device_mirror(shard_cap=64) is m
        assert m.syncs == 0 and m.restages == 1

    def test_mirror_defaults_to_cuda(self):
        _, port = pools(100, 0)
        if torch.cuda.is_available():
            assert port.device_mirror(shard_cap=64).device.type == "cuda"
            return
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.device_mirror(shard_cap=64)
        cpu = port.device_mirror(shard_cap=64, device=CPU)
        assert port.device_mirror() is cpu      # None keeps the cached device


# ---------------------------------------------------------------------------
# hierarchical two-level greedy
# ---------------------------------------------------------------------------

def hierarchical_both(ref, port, budget, shard_cap):
    rs, ps = {}, {}
    r = ref_engine.hierarchical_greedy_knapsack(ref, budget, TH,
                                                shard_cap=shard_cap, stats=rs)
    port.device_mirror(shard_cap=shard_cap, device=CPU)
    p = engine.hierarchical_greedy_knapsack(port, budget, TH, stats=ps)
    np.testing.assert_array_equal(p[0], r[0])       # incl. pick order
    assert p[1:] == r[1:] and ps == rs
    flat = engine._flat_pool_greedy(port, budget, TH)
    np.testing.assert_array_equal(p[0], flat[0])
    assert p[1:] == flat[1:]
    return ps


class TestHierarchical:
    @pytest.mark.parametrize("budget", [50.0, 800.0, 8000.0])
    def test_matches_reference_and_flat(self, budget):
        stats = hierarchical_both(*pools(6000, 11), budget, 512)
        assert stats["path"] == "frontier" and stats["shards"] >= 2

    def test_tie_heavy_pool(self):
        ref, port = pools(4000, 12)
        for p in (ref, port):
            p.scores[:] = np.round(p.scores * 4) / 4       # massive ties
            p.costs[:] = np.round(np.maximum(p.costs, 1.0))
            p._overall = None
        hierarchical_both(ref, port, 400.0, 256)

    def test_escalation(self):
        ref, port = pools(2000, 13)
        for p in (ref, port):
            p.costs[:256] = 1.0                  # shard 0 = cheap = hot
            p._overall = None
        assert hierarchical_both(ref, port, 150.0, 256)["escalations"] >= 1

    def test_flat_fallback(self):
        ref, port = pools(3000, 14)
        stats = hierarchical_both(ref, port, 10.0 * port.n, 512)
        assert stats["path"] == "flat-fallback"

    def test_post_churn_reselection(self):
        ref, port = pools(3000, 15)
        rm = ref.device_mirror(shard_cap=512)
        pm = port.device_mirror(shard_cap=512, device=CPU)
        for i in range(3):
            churn_both(ref, port, 300 + i, 80)
            r = ref_engine.hierarchical_greedy_knapsack(ref, 900.0, TH,
                                                        mirror=rm)
            p = engine.hierarchical_greedy_knapsack(port, 900.0, TH,
                                                    mirror=pm)
            np.testing.assert_array_equal(p[0], r[0])
            assert p[1:] == r[1:]
        assert pm.restages == 1

    def test_batch_matches_per_task(self):
        _, port = pools(2500, 16)
        port.device_mirror(shard_cap=512, device=CPU)
        budgets, ths = [60.0, 700.0], [TH, None]
        outs = engine.hierarchical_greedy_knapsack_batch(port, budgets, ths)
        for b, th, out in zip(budgets, ths, outs):
            one = engine.hierarchical_greedy_knapsack(port, b, th)
            np.testing.assert_array_equal(out[0], one[0])
            assert out[1:] == one[1:]

    def test_frontier_goes_through_the_op(self):
        _, port = pools(1500, 17)
        m = port.device_mirror(shard_cap=512, device=CPU)
        ratio = m.masked_ratio(m.valid_mask(TH))
        vals, rows = m.frontier(ratio, 8)
        v_ref, l_ref = ops.segmented_topk(ratio, 8)
        np.testing.assert_array_equal(vals, v_ref.numpy())
        np.testing.assert_array_equal(
            rows, np.arange(m.num_shards)[:, None] * 512 + l_ref.numpy())


def route_both(monkeypatch, min_n, shard_cap):
    for mod in (ref_device_pool, device_pool):
        monkeypatch.setattr(mod, "HIERARCHICAL_MIN_N", min_n)
    monkeypatch.setattr(ref_device_pool, "DEFAULT_SHARD_CAP", shard_cap)


class TestRoutes:
    @pytest.mark.parametrize("budget,n_star", [(700.0, 5), (2.0, 50)])
    def test_select_initial_pool(self, monkeypatch, budget, n_star):
        ref, port = pools(2500, 18)
        route_both(monkeypatch, 1000, 512)
        m = port.device_mirror(shard_cap=512, device=CPU)
        r = ref_selection.select_initial_pool(ref, budget, n_star=n_star,
                                              thresholds=TH)
        p = selection.select_initial_pool(port, budget, n_star=n_star,
                                          thresholds=TH)
        assert port._mirror is m and m.restages == 1   # the routed path ran
        assert (p.selected, p.total_score, p.total_cost, p.feasible,
                p.note) == (r.selected, r.total_score, r.total_cost,
                            r.feasible, r.note)
        monkeypatch.setattr(device_pool, "HIERARCHICAL_MIN_N", 10**9)
        flat = selection.select_initial_pool(port, budget, n_star=n_star,
                                             thresholds=TH)
        assert (flat.selected, flat.note) == (p.selected, p.note)

    def test_select_pools_batch(self, monkeypatch):
        ref, port = pools(2200, 19)
        route_both(monkeypatch, 1000, 512)
        port.device_mirror(shard_cap=512, device=CPU)
        budgets = [120.0, 950.0, 4000.0, 3.0]
        stars = [3, 3, 3, 40]
        rtasks = [RefTask(budget=b, n_star=s, thresholds=TH, seed=i)
                  for i, (b, s) in enumerate(zip(budgets, stars))]
        ptasks = [TaskRequest(budget=b, n_star=s, thresholds=TH, seed=i)
                  for i, (b, s) in enumerate(zip(budgets, stars))]
        r = RefProvider(ref).select_pools_batch(rtasks)
        sp = FLServiceProvider(port)
        p = sp.select_pools_batch(ptasks)
        assert port._mirror.num_shards >= 2
        monkeypatch.setattr(device_pool, "HIERARCHICAL_MIN_N", 10**9)
        flat = sp.select_pools_batch(ptasks)
        for a, b, f in zip(r, p, flat):
            assert (b.selected, b.total_score, b.total_cost, b.feasible,
                    b.note) == (a.selected, a.total_score, a.total_cost,
                                a.feasible, a.note)
            assert (f.selected, f.feasible) == (b.selected, b.feasible)
            assert f.total_cost == pytest.approx(b.total_cost, rel=1e-12)


# ---------------------------------------------------------------------------
# the batched multi-task greedy
# ---------------------------------------------------------------------------

def knapsack(seed, n, tasks):
    rng = np.random.default_rng(seed)
    s = rng.uniform(1, 10, n)
    c = np.rint(rng.uniform(3, 25, n))
    valid = rng.uniform(size=(tasks, n)) < 0.7
    budgets = np.linspace(40.0, 3000.0, tasks)
    return s, c, budgets, valid


class TestGreedyBatch:
    @pytest.mark.parametrize("skip", [False, True])
    @pytest.mark.parametrize("with_valid", [False, True])
    def test_numpy_bit_exact(self, skip, with_valid):
        s, c, budgets, valid = knapsack(1, 300, 5)
        v = valid if with_valid else None
        r = ref_engine.greedy_knapsack_batch(s, c, budgets, v, skip,
                                             backend="numpy")
        p = engine.greedy_knapsack_batch(s, c, budgets, v, skip,
                                         backend="numpy")
        for a, b in zip(r, p):
            np.testing.assert_array_equal(b, a)

    @pytest.mark.parametrize("seed,n", [(2, 100), (3, 1000), (4, 5000)])
    def test_device_matches_reference_jax(self, seed, n):
        s, c, budgets, valid = knapsack(seed, n, 4)
        r_masks = ref_engine.greedy_knapsack_batch(s, c, budgets, valid,
                                                   backend="jax")[0]
        masks, ts, tc = engine.greedy_knapsack_batch(
            s, c, budgets, valid, backend="device", device=CPU)
        np.testing.assert_array_equal(masks, r_masks)
        np.testing.assert_array_equal(ts, masks @ s)
        np.testing.assert_array_equal(tc, masks @ c)

    def test_auto_is_numpy_without_cuda(self):
        """``"auto"`` is numpy with or without CUDA (the reference's own
        choice off the TPU), so the default picks never depend on it."""
        s, c, budgets, valid = knapsack(5, 200, 3)
        a = engine.greedy_knapsack_batch(s, c, budgets, valid)
        b = engine.greedy_knapsack_batch(s, c, budgets, valid,
                                         backend="numpy")
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    @pytest.mark.parametrize("seed,n,with_valid", [
        (2, 100, True), (3, 1000, True), (4, 5000, False), (7, 1, True)])
    def test_device_skip_unaffordable_matches_numpy(self, seed, n,
                                                    with_valid):
        """The skip rule on the device (integer costs: its f32 sums are
        exact) picks what the numpy backend and the reference's jax
        backend pick."""
        s, c, budgets, valid = knapsack(seed, n, 4)
        v = valid if with_valid else None
        want = engine.greedy_knapsack_batch(s, c, budgets, v, True,
                                            backend="numpy")
        masks, ts, tc = engine.greedy_knapsack_batch(
            s, c, budgets, v, True, backend="device", device=CPU)
        np.testing.assert_array_equal(masks, want[0])
        np.testing.assert_array_equal(ts, want[1])
        np.testing.assert_array_equal(tc, want[2])
        r_masks = ref_engine.greedy_knapsack_batch(s, c, budgets, v, True,
                                                   backend="jax")[0]
        np.testing.assert_array_equal(masks, r_masks)
        # the skip rule takes a superset of the paper's prefix
        prefix = engine.greedy_knapsack_batch(s, c, budgets, v,
                                              backend="device", device=CPU)[0]
        assert (masks >= prefix).all()

    def test_device_refusals(self):
        s, c, budgets, valid = knapsack(6, 50, 2)
        with pytest.raises(ValueError, match="'device'"):
            engine.greedy_knapsack_batch(s, c, budgets, backend="jax")
        with pytest.raises(ValueError, match="'device'"):
            engine.greedy_knapsack_batch(s, c, budgets, valid, True,
                                         backend="tpu")

    def test_select_pools_batch_serves_tasks(self):
        """The multi-tenant intake raised before the batch was ported."""
        ref, port = pools(300, 20)
        tasks = [(150.0, None), (600.0, np.full(9, 0.2)), (1e6, TH)]
        r = RefProvider(ref).select_pools_batch(
            [RefTask(budget=b, n_star=2, thresholds=t) for b, t in tasks])
        p = FLServiceProvider(port).select_pools_batch(
            [TaskRequest(budget=b, n_star=2, thresholds=t) for b, t in tasks])
        for a, b in zip(r, p):
            assert (b.selected, b.total_score, b.total_cost, b.feasible) == \
                (a.selected, a.total_score, a.total_cost, a.feasible)


# ---------------------------------------------------------------------------
# stage 2 on the device
# ---------------------------------------------------------------------------

def mkp_instance(seed, n, m=7):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 30, size=(n, m)).astype(float)
    v = w.sum(axis=1) + rng.uniform(0, 5, n)
    return v, w, 0.4 * w.sum(axis=0)


def greedy_instance(kind, n, m=7, seed=0):
    """An f32 MKP instance (values, weights, capacities) from
    :func:`mkp_instance`. ``ties``: values the weights' sums and one
    power-of-two capacity for every knapsack, as the default capacities
    give one value for every class; with it the first utilities tie
    exactly in f32 (every product and sum is exact whatever the order),
    so the first index wins in both packages. ``all``: every item fits;
    ``nofit``: none does; ``nan`` / ``inf``: one fitting item's value is
    NaN / +inf (argmax takes the first NaN, else the +inf, in both
    packages, and the greedy stops there); ``zero``: one item weighs
    nothing (utility v / 1e-12); ``nan_penalty``: an infinite capacity
    and an infinite weight, whose penalty inf * 0 is NaN."""
    v, w, cap = mkp_instance(seed, n, m)
    j = n // 3
    if kind == "ties":
        v, cap = w.sum(axis=1), np.full(m, 64.0)
    elif kind == "all":
        cap = w.sum(axis=0) + 1
    elif kind == "nofit":
        w, cap = w + 1, np.full(m, 0.5)
    elif kind in ("nan", "inf"):
        w[j], cap = 1, np.maximum(cap, 1)
        v[j] = np.nan if kind == "nan" else np.inf
    elif kind == "zero":
        w[j] = 0
    elif kind == "nan_penalty":
        cap, w[j] = np.maximum(cap, 1), 1
        cap[0], w[j, 0] = np.inf, np.inf
    return tuple(np.asarray(a, np.float32) for a in (v, w, cap))


# (kind, n, max_size): max_size None (n picks) and past n, n = 1
GREEDY_CASES = [("random", 60, None), ("random", 80, 7), ("ties", 40, None),
                ("ties", 150, 13), ("all", 25, None), ("all", 25, 40),
                ("random", 1, None), ("all", 1, 5), ("nofit", 30, None),
                ("nan", 30, None), ("inf", 30, None), ("zero", 30, 9),
                ("nan_penalty", 30, None)]


class TestDeviceMKP:
    @pytest.mark.parametrize("seed,n,max_size",
                             [(4, 25, None), (5, 60, None), (6, 80, 7)])
    def test_greedy_matches_reference_jax(self, seed, n, max_size):
        v, w, cap = mkp_instance(seed, n)
        r_mask, r_used = ref_engine.solve_mkp_greedy_jax(v, w, cap, max_size)
        before = ops.LAUNCHES["mkp_utility"]
        mask, used = engine.solve_mkp_greedy_device(v, w, cap, max_size,
                                                    device=CPU)
        assert ops.LAUNCHES["mkp_utility"] == before     # plain path on CPU
        np.testing.assert_array_equal(mask, r_mask)
        np.testing.assert_array_equal(used, r_used)
        leg = mkp.solve_mkp_greedy(v, w, cap, max_size, local_search=False)
        assert sorted(np.flatnonzero(mask).tolist()) == leg.selected

    @pytest.mark.parametrize("interpret", [None, True],
                             ids=["jnp", "interpret"])
    @pytest.mark.parametrize("kind,n,max_size", GREEDY_CASES, ids=str)
    def test_plain_greedy_matches_reference_jax(self, kind, n, max_size,
                                                interpret):
        """``ref.mkp_greedy_ref``, the plain version of the greedy kernel,
        against the reference's ``solve_mkp_greedy_jax`` through its jnp
        utility and its Pallas kernel in interpret mode: mask and used
        equal, and the port's CPU route through ``ops.mkp_greedy`` and
        ``solve_mkp_greedy_device`` counts no launch."""
        v, w, cap = greedy_instance(kind, n)
        r_mask, r_used = ref_engine.solve_mkp_greedy_jax(
            v, w, cap, max_size, interpret=interpret)
        vt, wt, ct = (torch.as_tensor(a) for a in (v, w, cap))
        mask, used = ref_kernels.mkp_greedy_ref(vt, wt, ct, max_size)
        np.testing.assert_array_equal(mask.numpy(), r_mask)
        np.testing.assert_array_equal(used.numpy(), r_used)
        if kind in ("nan", "inf", "nofit", "nan_penalty"):
            assert not r_mask.any()           # the first pick is not finite
        before = dict(ops.LAUNCHES)
        got = ops.mkp_greedy(vt, wt, ct, max_size)
        e_mask, e_used = engine.solve_mkp_greedy_device(v, w, cap, max_size,
                                                        device=CPU)
        assert ops.LAUNCHES == before
        assert torch.equal(got[0], mask) and torch.equal(got[1], used)
        np.testing.assert_array_equal(e_mask, r_mask)
        np.testing.assert_array_equal(e_used, r_used)

    def test_solve_mkp_device_backend(self):
        v, w, cap = mkp_instance(7, 40)
        r = ref_mkp.solve_mkp(v, w, cap, backend="jax")
        p = mkp.solve_mkp(v, w, cap, backend="device", device=CPU)
        assert (p.selected, p.value, p.optimal) == \
            (r.selected, r.value, r.optimal)
        np.testing.assert_array_equal(p.used, r.used)
        with pytest.raises(ValueError, match="'device'"):
            mkp.solve_mkp(v, w, cap, backend="jax")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                mkp.solve_mkp(v, w, cap, backend="device")

    @pytest.mark.parametrize("n_clients,n,delta", [(60, 5, 1), (150, 10, 3)])
    def test_generate_subsets_device(self, n_clients, n, delta):
        """With the default capacities (one value for every class) each
        item's first utility is |h|_1 / (|h|_1 / cap) = cap in exact
        arithmetic, so rounding alone would pick the first client and
        the reference's dot and the port's column sum round apart. The
        capacities here differ by class, so the utilities are distinct."""
        ref, port = pools(n_clients, 21)
        caps = scheduling.default_capacities_arrays(port.histograms, n) \
            * np.random.default_rng(22).uniform(0.8, 1.2, 10)
        r = ref_scheduling.generate_subsets(ref, n, delta, capacities=caps,
                                            backend="jax")
        p = scheduling.generate_subsets(port, n, delta, capacities=caps,
                                        backend="device", device=CPU)
        assert p.subsets == r.subsets and p.counts == r.counts
        np.testing.assert_array_equal(np.asarray(p.nids), np.asarray(r.nids))

    @pytest.mark.parametrize("n_clients,n,delta,seed",
                             [(60, 5, 1, 21), (150, 10, 3, 5)])
    def test_generate_subsets_device_default_capacities(self, n_clients, n,
                                                        delta, seed):
        """At the default capacities, what every service path uses, the
        first utilities tie in exact arithmetic (see above), so the two
        packages' schedules may differ from the first pick. What holds:
        the first utilities agree to rtol 1e-6 and all equal the
        capacity to that tolerance (a tie, not a different ranking);
        from the same first pick on, the MKP greedy picks the same
        items; and both schedules cover the pool within x*."""
        ref, port = pools(n_clients, seed)
        H = port.histograms
        cap = scheduling.default_capacities_arrays(H, n)
        v = H.sum(axis=1)
        all_items = np.ones(n_clients, bool)
        u_p = ops.mkp_utility(*(torch.tensor(a, dtype=torch.float32)
                                for a in (v, H, cap)),
                              torch.tensor(all_items)).numpy()
        u_r = np.asarray(ref_kernels_ref.mkp_utility_ref(v, H, cap,
                                                         all_items))
        np.testing.assert_allclose(u_p, u_r, rtol=1e-6)
        np.testing.assert_allclose(u_p, np.full(n_clients, cap[0]),
                                   rtol=1e-6)
        size = n + delta
        for first in {int(np.argmax(u_p)), int(np.argmax(u_r)), 7}:
            rest = np.delete(np.arange(n_clients), first)
            residual = (cap.astype(np.float32) - H[first].astype(np.float32))
            r_mask, r_used = ref_engine.solve_mkp_greedy_jax(
                v[rest], H[rest], residual, size - 1)
            mask, used = engine.solve_mkp_greedy_device(
                v[rest], H[rest], residual, size - 1, device=CPU)
            assert mask.any()
            np.testing.assert_array_equal(mask, r_mask)
            np.testing.assert_array_equal(used, r_used)
        r = ref_scheduling.generate_subsets(ref, n, delta, backend="jax")
        p = scheduling.generate_subsets(port, n, delta, backend="device",
                                        device=CPU)
        ids = sorted(port.client_ids.tolist())
        for sched, report in ((r, ref_fairness.fairness_report),
                              (p, fairness.fairness_report)):
            rep = report(sched, ids, x_star=3)
            assert rep["coverage"] and rep["bounded"]


# ---------------------------------------------------------------------------
# ServiceScheduler intake
# ---------------------------------------------------------------------------

def _stub(rnd, subset, weights):
    subset = np.asarray(subset)
    returned = (subset + rnd) % 7 != 0
    q = np.where(returned, 0.5 + 0.4 * np.cos(subset + rnd), 0.0)
    return returned, q, {"round": rnd, "loss": 1.0 / (rnd + 1)}


def test_service_scheduler_admits_tasks_like_reference():
    def tasks(cls):
        return [cls(budget=300.0 + 20 * t, n_star=5, subset_size=4,
                    subset_delta=2, max_periods=2,
                    scheduler="mkp" if t % 2 else "random", seed=t)
                for t in range(6)]

    ref_sched = RefScheduler(RefProvider(
        ref_random_profiles(60, 10, np.random.default_rng(0))))
    sched = ServiceScheduler(FLServiceProvider(
        random_profiles(60, 10, np.random.default_rng(0))))
    for a, b in zip(tasks(RefTask), tasks(TaskRequest)):
        ref_sched.submit(a, _stub)
        sched.submit(b, _stub)
    r, p = ref_sched.run(), sched.run()
    assert sorted(p) == sorted(r) and len(p) == 6
    for tid in r:
        a, b = r[tid], p[tid]
        assert (b.pool.selected, b.pool.total_score, b.pool.total_cost,
                b.pool.feasible) == (a.pool.selected, a.pool.total_score,
                                     a.pool.total_cost, a.pool.feasible)
        assert [(e.period, e.round_index, e.subset) for e in b.rounds] == \
            [(e.period, e.round_index, e.subset) for e in a.rounds]
        assert b.num_rounds == a.num_rounds > 0
        assert b.reputation == a.reputation
    # and each admitted task equals its serial run through submit/drain
    sp = FLServiceProvider(random_profiles(60, 10, np.random.default_rng(0)))
    st, _ = drain(sp, submit(sp, tasks(TaskRequest)[1]), _stub)
    rsp = RefProvider(ref_random_profiles(60, 10, np.random.default_rng(0)))
    rst, _ = ref_drain(rsp, ref_submit(rsp, tasks(RefTask)[1]), _stub)
    assert [e.subset for e in st.rounds] == [e.subset for e in rst.rounds]
