"""Port parity for the placement fabric: the ``core.placement`` registry,
cost model and shipped policies, the multi-device ``ServiceScheduler``
(per-device windows, placement, migration), and the device side that
the port adds to it: ``DeviceFLSim.place_on``, ``DeviceFLSim(mesh=)``
and the client-sharded round scan, ``sample_positions(slot_offset=)``
and ``DeviceDataset.stage(cap=)``.

The scheduler cases are the JAX package's own (tests/test_placement.py)
with the same deterministic stub trainers, run through both packages:
placements, round events, reputation and migration counts must be equal
bit for bit. Draws are bit-exact. The sharded scan differs from the
unsharded plane only in the f32 order of its sums (the shards' weighted
sums are added in shard order on the mesh's first device): masks are
equal, q-values, losses and parameters within rtol 1e-3 / atol 1e-4,
the reference's own bounds for its sharded scan.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.fl import device_data as ref_dd
from repro.fl import simulation as ref_sim
from repro.models import cnn as jcnn
from repro_torch import random as trandom
from repro_torch.core import placement as port_placement
from repro_torch.data.synthetic import make_classification_data
from repro_torch.fl import device_data
from repro_torch.fl.partition import partition_labels
from repro_torch.fl.round import make_fl_rounds_scan_sharded, shard_devices
from repro_torch.fl.simulation import DeviceFLSim, SimConfig
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import cnn
from repro_torch.sharding import specs

PACKAGES = {"reference": ref_core, "port": port_core}


# ---------------------------------------------------------------------------
# the reference's deterministic stub trainers (tests/test_placement.py)
# ---------------------------------------------------------------------------

def _round_result(rnd, subset, fail_mod=7):
    subset = np.asarray(subset)
    returned = (subset + rnd) % fail_mod != 0
    q = np.where(returned, 0.5 + 0.4 * np.cos(subset + rnd), 0.0)
    return returned, q, {"round": rnd, "loss": 1.0 / (rnd + 1)}


class AsyncChunkStub:
    chunkable = True

    def dispatch_rounds(self, start_round, subsets, weights):
        return (start_round, [list(s) for s in subsets])

    def collect(self, handle):
        start_round, subsets = handle
        return [_round_result(start_round + j, s)
                for j, s in enumerate(subsets)]

    def run_rounds(self, start_round, subsets, weights):
        return self.collect(self.dispatch_rounds(start_round, subsets,
                                                 weights))


class PlacedAsyncStub(AsyncChunkStub):
    """Honors ``place_on`` and records the in-flight depth per device."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.device = None

    def place_on(self, device_index):
        self.device = int(device_index)

    def dispatch_rounds(self, start_round, subsets, weights):
        r = self.fleet.setdefault(self.device, {"inflight": 0, "max": 0})
        r["inflight"] += 1
        r["max"] = max(r["max"], r["inflight"])
        return (self.device, start_round, [list(s) for s in subsets])

    def collect(self, handle):
        device, start_round, subsets = handle
        self.fleet[device]["inflight"] -= 1
        return [_round_result(start_round + j, s)
                for j, s in enumerate(subsets)]


def _profiles(core, n=60, seed=0):
    return core.random_profiles(n, 10, np.random.default_rng(seed))


def _tasks(core, T, max_periods=2):
    return [core.TaskRequest(budget=300.0 + 20 * t, n_star=5, subset_size=4,
                             subset_delta=2, max_periods=max_periods,
                             scheduler="mkp" if t % 2 else "random", seed=t)
            for t in range(T)]


def _result_key(res):
    """A run result as plain data: the pool, every round event, the
    reputation."""
    return (sorted(res.pool.selected),
            [(e.period, e.round_index, list(e.subset), e.weights.tolist(),
              e.nid, e.metrics) for e in res.rounds],
            res.reputation)


def _outcome(fn):
    """``("ok", value)`` or ``("raised", type name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:   # noqa: BLE001 (the outcome is compared)
        return ("raised", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# registry, cost model, shipped policies
# ---------------------------------------------------------------------------

class _Dup:
    name = "bin_pack"

    def place(self, tids, n_devices, costs, loads, counts):
        return {}


class _NoPlace:
    name = "no_place"


REGISTRY_CASES = {
    "shipped": lambda c: sorted({"bin_pack", "round_robin"}
                                & set(c.available_placement_policies())),
    "unknown": lambda c: c.placement_policy("nope"),
    "duplicate": lambda c: c.register_placement_policy(_Dup),
    "non_conforming": lambda c: c.register_placement_policy(_NoPlace),
    "resolve_default": lambda c: c.resolve_placement_policy(None).name,
    "resolve_name": lambda c: c.resolve_placement_policy("round_robin").name,
    "resolve_instance": lambda c: c.resolve_placement_policy(
        c.placement_policy("bin_pack")).name,
    "resolve_bad": lambda c: c.resolve_placement_policy(42),
}
REGISTRY_WANT = {"shipped": ("ok", ["bin_pack", "round_robin"]),
                 "unknown": "KeyError", "duplicate": "ValueError",
                 "non_conforming": "TypeError",
                 "resolve_default": ("ok", "bin_pack"),
                 "resolve_name": ("ok", "round_robin"),
                 "resolve_instance": ("ok", "bin_pack"),
                 "resolve_bad": "TypeError"}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_matches_reference(case):
    got = {k: _outcome(lambda: REGISTRY_CASES[case](c))
           for k, c in PACKAGES.items()}
    assert got["port"] == got["reference"]
    want = REGISTRY_WANT[case]
    if isinstance(want, str):
        assert got["port"][:2] == ("raised", want)
    else:
        assert got["port"] == want
    if case == "unknown":
        assert "bin_pack" in got["port"][2]


def _mods():
    return {"reference": ref_core.placement, "port": port_placement}


COST_CASES = {
    "none": lambda m: m.estimate_cost(None),
    "empty": lambda m: m.estimate_cost({}),
    "no_samples": lambda m: m.estimate_cost({"obs/latency": np.array([])}),
    "invalid_samples": lambda m: m.estimate_cost(
        {"obs/latency": np.array([np.nan, -1.0, 0.0])}),
    "valid_mean": lambda m: m.estimate_cost(
        {"obs/latency": np.array([2.0, np.nan, 4.0, -3.0])}),
    "loads": lambda m: m.device_loads({0: 0, 1: 1, 2: 0},
                                      {0: 2.0, 1: 1.0, 2: 1.0}, 2).tolist(),
    "counts": lambda m: m.device_counts({0: 0, 1: 1, 2: 0}, 2).tolist(),
    "imbalance": lambda m: m.imbalance(np.array([3.0, 1.0])),
    "imbalance_empty": lambda m: m.imbalance(np.array([])),
    "imbalance_zeros": lambda m: m.imbalance(np.zeros(4)),
}
COST_WANT = {"none": 1.0, "empty": 1.0, "no_samples": 1.0,
             "invalid_samples": 1.0, "valid_mean": 3.0, "loads": [3.0, 1.0],
             "counts": [2.0, 1.0], "imbalance": 1.5, "imbalance_empty": 1.0,
             "imbalance_zeros": 1.0}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_model_matches_reference(case):
    got = {k: COST_CASES[case](m) for k, m in _mods().items()}
    assert got["port"] == got["reference"] == COST_WANT[case]


POLICY_CASES = {
    # name: (policy, tids, n_devices, costs, loads, counts, expected)
    "round_robin_cyclic": ("round_robin", [10, 11, 12, 13, 14], 3, {},
                           np.zeros(3), np.zeros(3),
                           {10: 0, 11: 1, 12: 2, 13: 0, 14: 1}),
    "round_robin_continues": ("round_robin", [7, 8], 3, {}, np.zeros(3),
                              np.array([2.0, 1.0, 1.0]), {7: 1, 8: 2}),
    "bin_pack_lpt": ("bin_pack", [1, 2, 3, 4], 2,
                     {1: 5.0, 2: 3.0, 3: 2.0, 4: 2.0}, np.zeros(2),
                     np.zeros(2), {1: 0, 2: 1, 3: 1, 4: 0}),
    "bin_pack_existing_loads": ("bin_pack", [9], 2, {9: 1.0},
                                np.array([10.0, 0.5]), np.array([1.0, 1.0]),
                                {9: 1}),
    "bin_pack_unit_cost": ("bin_pack", [0, 1, 2, 3], 2, {}, np.zeros(2),
                           np.zeros(2), None),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_shipped_policies_match_reference(case):
    name, tids, n, costs, loads, counts, want = POLICY_CASES[case]
    got = {k: c.placement_policy(name).place(tids, n, costs, loads.copy(),
                                             counts.copy())
           for k, c in PACKAGES.items()}
    assert got["port"] == got["reference"]
    if want is not None:
        assert got["port"] == want
    else:
        assert sorted(port_placement.device_counts(got["port"], 2)) == \
            [2.0, 2.0]


# ---------------------------------------------------------------------------
# ServiceScheduler: placement, per-device windows, migration
# ---------------------------------------------------------------------------

def _serial(core, tasks):
    out = []
    for task in tasks:
        sp = core.FLServiceProvider(_profiles(core))
        st = core.drain(sp, core.submit(sp, task), AsyncChunkStub())[0]
        out.append(_result_key(core.as_run_result(st)))
    return out


def _scheduled(core, n_tasks=6, stub=AsyncChunkStub, **kw):
    sched = core.ServiceScheduler(core.FLServiceProvider(_profiles(core)),
                                  **kw)
    for task in _tasks(core, n_tasks):
        sched.submit(task, stub())
    conc = sched.run()
    return sched, [_result_key(conc[tid]) for tid in sorted(conc)]


def _inject_latency(sched):
    for tid in sched.task_ids:
        st = sched.state(tid)
        if not st.phase.terminal:
            st.policy_state["obs/latency"] = np.full(
                8, 20.0 if tid == 0 else 1.0)


def _run_injected(core, **kw):
    sched = core.ServiceScheduler(core.FLServiceProvider(_profiles(core)),
                                  overlap=True, **kw)
    for task in _tasks(core, 6, max_periods=3):
        sched.submit(task, AsyncChunkStub())
    for _ in range(10_000):
        if not sched.active:
            break
        sched.sweep()
        _inject_latency(sched)
    assert not sched.active
    return sched, [_result_key(core.as_run_result(sched.state(tid)))
                   for tid in sched.task_ids]


def scenario_devices(core, overlap, n_devices, placement):
    sched, results = _scheduled(core, overlap=overlap, n_devices=n_devices,
                                placement=placement)
    assert results == _serial(core, _tasks(core, 6))
    placed = sched.placements()
    assert all(0 <= d < n_devices for d in placed.values())
    return results, placed


def scenario_windows(core):
    fleet = {}
    sched, results = _scheduled(core, n_tasks=8,
                                stub=lambda: PlacedAsyncStub(fleet),
                                max_inflight=2, overlap=True, n_devices=2,
                                placement="round_robin")
    assert set(fleet) == {0, 1}
    assert all(r["max"] <= 2 and r["inflight"] == 0 for r in fleet.values())
    assert sum(r["max"] for r in fleet.values()) > 2
    assert results == _serial(core, _tasks(core, 8))
    return results, fleet, sched.placements()


def scenario_live_tenants(core):
    sched = core.ServiceScheduler(core.FLServiceProvider(_profiles(core)),
                                  n_devices=2, placement="round_robin")
    tids = [sched.submit(t, AsyncChunkStub()) for t in _tasks(core, 4)]
    assert sched.device_of(999) == 0
    sched.sweep()
    placed = sched.placements()
    assert sorted(placed) == sorted(tids)
    assert set(placed.values()) == {0, 1}
    assert all(sched.device_of(t) == placed[t] for t in tids)
    return placed


def scenario_rebalance(core):
    _, ref = _run_injected(core, n_devices=1, max_inflight=1)
    sched, got = _run_injected(core, n_devices=3, max_inflight=1,
                               placement="bin_pack", rebalance_threshold=1.2)
    assert sched.migrations >= 1
    assert got == ref
    return got, sched.migrations, sched.placements()


def scenario_midperiod(core):
    sched = core.ServiceScheduler(core.FLServiceProvider(_profiles(core)),
                                  overlap=True, n_devices=3,
                                  placement="bin_pack")
    for task in _tasks(core, 6):
        sched.submit(task, AsyncChunkStub())
    sched.sweep()
    before = sched.placements()
    assert any(sched.state(t).pending is not None for t in sched.task_ids)
    assert sched.rebalance() == 0
    assert sched.placements() == before and sched.migrations == 0
    return before


def scenario_manual_rebalance(core):
    task = _tasks(core, 1)[0]
    ref = _serial(core, [task])[0]
    sched = core.ServiceScheduler(core.FLServiceProvider(_profiles(core)),
                                  overlap=False, n_devices=2,
                                  placement="round_robin")
    tid = sched.submit(task, AsyncChunkStub())
    for _ in range(10_000):
        sched.sweep()
        st = sched.state(tid)
        if st.phase in (core.TaskPhase.POOL_SELECTED,
                        core.TaskPhase.PERIOD_CHECKPOINT) \
                and st.pending is None and st.period >= 1:
            break
    assert not st.phase.terminal
    old_dev = sched.device_of(tid)
    st.policy_state["obs/latency"] = np.full(8, 50.0)
    moved = sched.rebalance()
    assert moved == sched.migrations
    if moved:
        assert sched.device_of(tid) != old_dev
    sched.run()
    got = _result_key(core.as_run_result(sched.state(tid)))
    assert got == ref
    return got, old_dev, moved, sched.placements()


SCENARIOS = {
    "one_device_blocking": lambda c: scenario_devices(c, False, 1,
                                                      "bin_pack"),
    "one_device_overlapped": lambda c: scenario_devices(c, True, 1,
                                                        "bin_pack"),
    "three_devices_bin_pack": lambda c: scenario_devices(c, True, 3,
                                                         "bin_pack"),
    "three_devices_round_robin": lambda c: scenario_devices(c, True, 3,
                                                            "round_robin"),
    "eight_devices_bin_pack": lambda c: scenario_devices(c, True, 8,
                                                         "bin_pack"),
    "per_device_windows": scenario_windows,
    "placements_cover_live_tenants": scenario_live_tenants,
    "rebalance_migrates": scenario_rebalance,
    "midperiod_not_movable": scenario_midperiod,
    "manual_rebalance_at_boundary": scenario_manual_rebalance,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_matches_reference(name):
    """The reference's scheduler cases on both packages: each holds its
    own assertions, and placements, round events, reputation and
    migrations are equal between the packages bit for bit."""
    ref = SCENARIOS[name](ref_core)
    port = SCENARIOS[name](port_core)
    assert port == ref


class _BadPolicy:
    name = "bad_device"

    def place(self, tids, n_devices, costs, loads, counts):
        return {tid: 99 for tid in tids}


REJECTIONS = {
    "zero_devices": lambda c: c.ServiceScheduler(
        c.FLServiceProvider(_profiles(c)), n_devices=0),
    "threshold_at_one": lambda c: c.ServiceScheduler(
        c.FLServiceProvider(_profiles(c)), n_devices=2,
        rebalance_threshold=1.0),
    "out_of_range_placement": lambda c: _sweep_one(c, _BadPolicy()),
}


def _sweep_one(core, policy):
    sched = core.ServiceScheduler(core.FLServiceProvider(_profiles(core)),
                                  n_devices=2, placement=policy)
    sched.submit(_tasks(core, 1)[0], AsyncChunkStub())
    sched.sweep()


@pytest.mark.parametrize("case,match", [
    ("zero_devices", "n_devices"), ("threshold_at_one", "rebalance_threshold"),
    ("out_of_range_placement", "bad_device")])
def test_scheduler_rejections_match_reference(case, match):
    got = {k: _outcome(lambda: REJECTIONS[case](c))
           for k, c in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"][:2] == ("raised", "ValueError")
    assert match in got["port"][2]


# ---------------------------------------------------------------------------
# draws and staging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 1, 3, 6])
def test_slot_offset_draws_match_reference_and_unsharded_slice(offset):
    """A shard's draw at ``slot_offset=o`` is the reference's, bit for
    bit, and the slice ``[o:o+n]`` of an unsharded draw (rounds as a
    tensor, as the port's chunk draws them)."""
    n, E, b, seed = 3, 2, 5, 11
    rounds = np.array([0, 4, 9])
    key = trandom.prng_key(seed)
    mask_u, pos_u = device_data.sample_positions(
        key, torch.as_tensor(rounds), n, E, b, slot_offset=offset)
    full_m, full_p = device_data.sample_positions(
        key, torch.as_tensor(rounds), offset + n, E, b)
    assert torch.equal(mask_u, full_m[:, offset:])
    assert torch.equal(pos_u, full_p[:, offset:])
    for i, r in enumerate(rounds):
        jm, jp = ref_dd.sample_positions(jax.random.PRNGKey(seed), r, n, E,
                                         b, slot_offset=offset)
        np.testing.assert_array_equal(mask_u[i].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(pos_u[i].numpy(), np.asarray(jp))


@pytest.mark.parametrize("cap", [None, 80, 200])
def test_stage_cap_matches_reference(cap):
    data = make_classification_data("mnist", 300, seed=0)
    parts = partition_labels(data.labels, 6, "type1", 10, seed=0)
    ref = ref_dd.DeviceDataset.stage(data, parts, cap=cap)
    port = device_data.DeviceDataset.stage(data, parts, "cpu", cap=cap)
    np.testing.assert_array_equal(port.pools.numpy(), np.asarray(ref.pools))
    np.testing.assert_array_equal(port.sizes.numpy(), np.asarray(ref.sizes))
    lm = device_data.DeviceLMDataset.stage(
        type("LM", (), {"tokens": np.zeros((300, 5), np.int32),
                        "labels": data.labels})(), parts, "cpu", cap=cap)
    assert torch.equal(lm.pools, port.pools)


def test_stage_cap_below_a_pool_raises_as_reference():
    data = make_classification_data("mnist", 300, seed=0)
    parts = partition_labels(data.labels, 6, "type1", 10, seed=0)
    with pytest.raises(ValueError, match="cap=10") as ref_err:
        ref_dd.DeviceDataset.stage(data, parts, cap=10)
    with pytest.raises(ValueError, match="cap=10") as port_err:
        device_data.DeviceDataset.stage(data, parts, "cpu", cap=10)
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# meshes and the client-sharded round scan (MNIST_CNN, the reference's
# tests/test_placement.py setting)
# ---------------------------------------------------------------------------

def test_mesh_axes_read_as_reference():
    mesh = make_host_mesh("cpu", 4)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (4, 1)
    assert specs.data_axes(mesh) == ("data",)
    assert specs.mesh_axis_size(mesh, "data") == 4
    assert specs.mesh_axis_size(mesh, ("data", "model")) == 4
    assert specs.mesh_axis_size(mesh, "pod") == 1
    pod = Mesh(np.array([[[torch.device("cpu")] * 2] * 3] * 2, dtype=object),
               ("pod", "data", "model"))
    assert specs.data_axes(pod) == ("pod", "data")
    assert specs.mesh_axis_size(pod, specs.data_axes(pod)) == 6
    assert len(shard_devices(pod)) == 6
    with pytest.raises(ValueError, match="shards"):
        make_host_mesh("cpu", 0)
    with pytest.raises(ValueError, match="axes"):
        Mesh(np.empty((2,), dtype=object), ("data", "model"))


SUBSETS = [[0, 1, 2], [3, 4, 5, 6], [7, 0, 1], [2, 3, 4]]
WEIGHTS = [np.full(len(s), 1.0 / len(s)) for s in SUBSETS]


def _mnist():
    d = make_classification_data("mnist", 600, seed=0)
    parts = partition_labels(d.labels, 8, "type1", 10, seed=0)
    return d, parts, make_classification_data("mnist", 100, seed=1)


def _sim_config(dropout_rate=0.0):
    return SimConfig(batch_size=8, local_steps=2, eval_every=1000,
                     dropout_rate=dropout_rate, seed=0)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.MNIST_CNN, jax.random.PRNGKey(0)))


def _port_sim(jax_params, shards=None, **kw):
    d, parts, test = _mnist()
    mesh = None if shards is None else make_host_mesh("cpu", shards)
    sim = DeviceFLSim(cnn.MNIST_CNN, d, parts, test, _sim_config(),
                      pad_subset_to=4, mesh=mesh,
                      device="cpu" if mesh is None else None, **kw)
    sim.params = cnn.params_from_jax(jax_params)
    return sim


@pytest.fixture(scope="module")
def planes(jax_params):
    """The four rounds on the JAX package's DeviceFLSim, the port's
    unsharded plane and the port's meshes of 1, 2 and 4 CPU shards."""
    d, parts, test = _mnist()
    jsim = ref_sim.DeviceFLSim(jcnn.MNIST_CNN, d, parts, test,
                               ref_sim.SimConfig(**vars(_sim_config())),
                               pad_subset_to=4)
    out = {"jax": (jsim.run_rounds(0, SUBSETS, WEIGHTS),
                   {f"{l}.{x}": np.asarray(jsim.params[l][x])
                    for l in jsim.params for x in jsim.params[l]})}
    for shards in (None, 1, 2, 4):
        sim = _port_sim(jax_params, shards)
        res = sim.run_rounds(0, SUBSETS, WEIGHTS)
        out[shards] = (res, {k: v.numpy() for k, v in sim.params.items()})
    return out


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("against", ["port", "jax"])
def test_sharded_plane_matches_unsharded(planes, shards, against):
    ref_res, ref_params = planes[None if against == "port" else "jax"]
    res, params = planes[shards]
    for (ma, qa, meta), (mb, qb, metb) in zip(ref_res, res):
        np.testing.assert_array_equal(mb, ma)         # masks bit-equal
        np.testing.assert_allclose(qb, qa, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(metb["loss"], meta["loss"], rtol=1e-3)
    for k in ref_params:
        np.testing.assert_allclose(params[k], ref_params[k], rtol=1e-3,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("kw,match", [
    ({"dropout_rate": 0.2}, "dropout"), ({"compression": "int8"},
                                         "uncompressed"),
    ({"server_opt": "fedadam"}, "uncompressed"),
    ({"device": "cpu"}, "first device")])
def test_mesh_mode_refuses_what_the_reference_refuses(kw, match):
    d, parts, test = _mnist()
    kw = dict(kw)
    sim = _sim_config(kw.pop("dropout_rate", 0.0))
    with pytest.raises(ValueError, match=match):
        DeviceFLSim(cnn.MNIST_CNN, d, parts, test, sim,
                    mesh=make_host_mesh("cpu", 2), **kw)


def test_sharded_chunk_requires_divisible_k(jax_params):
    d, parts, _ = _mnist()
    chunk = make_fl_rounds_scan_sharded(
        lambda p, b: cnn.loss_fn(cnn.MNIST_CNN, p, b),
        mesh=make_host_mesh("cpu", 2))
    K = 3
    sched = {"rows": torch.zeros((1, K), dtype=torch.int64),
             "weights": torch.full((1, K), 1.0 / K),
             "active": torch.ones((1, K)),
             "round_ids": torch.zeros(1, dtype=torch.int64)}
    with pytest.raises(ValueError, match="divisible"):
        chunk(cnn.params_from_jax(jax_params),
              device_data.DeviceDataset.stage(d, parts, "cpu"), sched,
              trandom.prng_key(1))


def test_sharded_k_pads_to_the_shard_count(jax_params):
    """K rounds up to a multiple of the shard count, past an odd
    ``pad_subset_to`` too (the reference rounds only for more than 2
    shards, so a 2-shard mesh under a cap of 13 sends it K = 13 and its
    chunk raises); the unsharded plane pads as before."""
    sim = _port_sim(jax_params, 4)
    assert [sim._k_pad(k) for k in (1, 2, 3, 4, 5)] == [4, 4, 4, 4, 8]
    assert list(sim.data) == [torch.device("cpu")]   # one staged copy
    sim = _port_sim(jax_params, 2)
    sim.pad_subset_to = 13
    assert [sim._k_pad(k) for k in (7, 11, 12, 13)] == [8, 12, 12, 14]
    plain = _port_sim(jax_params)
    plain.pad_subset_to = 13
    assert [plain._k_pad(k) for k in (7, 11, 12, 13)] == [8, 12, 12, 13]


def test_sharded_carry_exports_and_resumes(jax_params):
    """The sharded chunk carries the parameters alone: an exported state
    imported into a fresh sharded trainer resumes the same rounds."""
    whole = _port_sim(jax_params, 2)
    want = whole.run_rounds(0, SUBSETS, WEIGHTS)
    first = _port_sim(jax_params, 2)
    first.run_rounds(0, SUBSETS[:2], WEIGHTS[:2])
    resumed = _port_sim(jax_params, 2)
    resumed.import_state(first.export_state())
    got = resumed.run_rounds(2, SUBSETS[2:], WEIGHTS[2:])
    for (ma, qa, meta), (mb, qb, metb) in zip(want[2:], got):
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(qa, qb)
        assert meta == metb
    for k in whole.params:
        assert torch.equal(whole.params[k], resumed.params[k])


def test_place_on_zero_is_invisible_and_others_raise_on_cpu(planes,
                                                           jax_params):
    sim = _port_sim(jax_params)
    sim.place_on(0)
    res = sim.run_rounds(0, SUBSETS, WEIGHTS)
    for (ma, qa, meta), (mb, qb, metb) in zip(planes[None][0], res):
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(qa, qb)
        assert meta == metb
    with pytest.raises(ValueError, match="index 0"):
        sim.place_on(1)
    sharded = _port_sim(jax_params, 2)
    sharded.place_on(1)                      # a no-op in mesh mode
    assert sharded.device == torch.device("cpu")


@pytest.mark.parametrize("n_devices", [1, 2])
def test_scheduler_places_real_trainers(jax_params, n_devices):
    """``ServiceScheduler(n_devices=...)`` fires each DeviceFLSim's
    ``place_on``: on one device the events equal the same tasks run
    without placement; a second device on a CPU trainer raises."""
    from repro_torch.core import (FLServiceProvider, ServiceScheduler,
                                  TaskRequest, as_run_result, drain, submit)
    from repro_torch.fl.simulation import pool_from_partition
    d, parts, _ = _mnist()
    pool = pool_from_partition(d.labels, parts, 10, seed=0)
    tasks = [TaskRequest(budget=1e9, n_star=8, subset_size=3,
                         subset_delta=1, x_star=3, max_periods=10_000,
                         seed=t, round_chunk=2, max_rounds=4)
             for t in range(2)]
    serial = []
    for task in tasks:
        sp = FLServiceProvider(pool)
        st, _ = drain(sp, submit(sp, task), _port_sim(jax_params))
        serial.append(_result_key(as_run_result(st)))
    sched = ServiceScheduler(FLServiceProvider(pool), n_devices=n_devices,
                             placement="round_robin")
    for task in tasks:
        sched.submit(task, _port_sim(jax_params))
    if n_devices > 1:
        with pytest.raises(ValueError, match="index 0"):
            sched.run()
        return
    conc = sched.run()
    assert sched.placements() == {0: 0, 1: 0}
    assert [_result_key(conc[t]) for t in sorted(conc)] == serial
