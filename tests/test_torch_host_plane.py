"""Port parity for the host-loop data plane: ``fl.round``'s two-pass
aggregate (``tree_weighted_sum``, ``_quality_cosines``),
``make_fl_round`` and the two-pass ``make_fl_rounds_scan``, the CNN's
``impl`` lowerings, ``FLClassificationSim`` and
``run_fl_experiment(data_plane="host")``, against the JAX package's.

The reference's kernel branch (``tree_weighted_sum(use_kernel=True)``)
calls the Pallas kernel without interpret mode, which the CPU refuses,
so the port's ``use_kernel=True`` (on the CPU: the plain
``fedavg_agg_ref`` per leaf) is held against the reference's plain
branch, the same sum, and against its Pallas kernel in interpret mode
(``repro.kernels.fedavg_agg.fedavg_agg_tree(interpret=True)``).

Tolerances: the weighted sums run over K terms in f32 in another order,
so they agree to rtol 1e-6 / atol 1e-7 on unit-normal data (the bf16
aggregate to one bf16 ulp, rtol 2**-7). A quality cosine's dots run over
P (about 207,000 for the MNIST CNN) in f32, and both frameworks sum
close to left to right, whose error grows about as sqrt(P) ulps: each
side is up to 4e-5 from the exact value, so cosines are held to atol
1e-4, as q-values everywhere in the port's tests. Logits of the two
frameworks' lowerings agree to 1e-5. Training outputs after a few
rounds from the same parameters follow tests/test_torch_round.py:
params rtol 1e-4 / atol 1e-5, losses rtol 1e-4, q-values atol 1e-4.
Host-side draws, batches, masks, subsets and schedules are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_classification_data as ref_make_data
from repro.fl import device_data as ref_dd
from repro.fl import round as ref_round
from repro.fl import simulation as ref_sim
from repro.fl.partition import partition_labels as ref_partition
from repro.kernels.fedavg_agg import fedavg_agg_tree as pallas_agg_tree
from repro.models import cnn as jcnn
from repro_torch import random as trandom
from repro_torch.data.synthetic import make_classification_data
from repro_torch.fl import device_data, round as fl_round, simulation
from repro_torch.fl.partition import partition_labels
from repro_torch.kernels import ops
from repro_torch.models import cnn

SEED = 5


def nested(flat: dict) -> dict:
    """Port flat dict of numpy arrays -> the reference's nested tree."""
    out = {}
    for name, v in flat.items():
        layer, leaf = name.split(".")
        out.setdefault(layer, {})[leaf] = v
    return out


def stacked_tree(K, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = cnn.param_shapes(cnn.MNIST_CNN)
    return {n: rng.standard_normal((K,) + s).astype(dtype)
            for n, s in shapes.items()}


def to_torch(tree, dtype=None):
    return {n: torch.as_tensor(v).to(dtype or torch.float32)
            for n, v in tree.items()}


def ref_params():
    tree = jcnn.init_params(jcnn.MNIST_CNN, jax.random.PRNGKey(SEED))
    return tree, cnn.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("K", [1, 3, 7])
def test_tree_weighted_sum_matches_reference(K):
    tree = stacked_tree(K, seed=K)
    w = np.random.default_rng(K).random(K).astype(np.float32)
    w /= w.sum()
    exp = ref_round.tree_weighted_sum(
        jax.tree_util.tree_map(jnp.asarray, nested(tree)), jnp.asarray(w))
    pallas = pallas_agg_tree(jax.tree_util.tree_map(jnp.asarray, nested(tree)),
                             jnp.asarray(w), interpret=True)
    for use_kernel in (False, True):
        got = fl_round.tree_weighted_sum(to_torch(tree), torch.as_tensor(w),
                                         use_kernel=use_kernel)
        for name, v in got.items():
            layer, leaf = name.split(".")
            for oracle in (exp, pallas):
                np.testing.assert_allclose(v.numpy(), oracle[layer][leaf],
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name} kernel={use_kernel}")
    plain = fl_round.tree_weighted_sum(to_torch(tree), torch.as_tensor(w),
                                       use_kernel=True, kernels=ops.PLAIN)
    on_cpu = fl_round.tree_weighted_sum(to_torch(tree), torch.as_tensor(w),
                                        use_kernel=True)
    assert all(torch.equal(plain[n], on_cpu[n]) for n in plain)


def test_tree_weighted_sum_bf16_weight_rounding():
    """The plain branch rounds the weights to the leaf's dtype (as the
    reference's plain branch); the kernel branch keeps them f32 (as the
    reference's kernel and oracle)."""
    K = 5
    tree = stacked_tree(K, seed=9)
    ut = {n: torch.as_tensor(v).to(torch.bfloat16) for n, v in tree.items()}
    uj = {n: jnp.asarray(v.to(torch.float32).numpy()).astype(jnp.bfloat16)
          for n, v in ut.items()}
    w = np.array([0.11, 0.23, 0.17, 0.29, 0.2], np.float32)
    plain = fl_round.tree_weighted_sum(ut, torch.as_tensor(w))
    kern = fl_round.tree_weighted_sum(ut, torch.as_tensor(w), use_kernel=True)
    exp = ref_round.tree_weighted_sum(nested(uj), jnp.asarray(w))
    pallas = pallas_agg_tree(nested(uj), jnp.asarray(w), interpret=True)
    for name in ut:
        layer, leaf = name.split(".")
        for got, oracle in ((plain, exp), (kern, pallas)):
            assert got[name].dtype == torch.bfloat16
            np.testing.assert_allclose(
                got[name].float().numpy(),
                np.asarray(oracle[layer][leaf]).astype(np.float32),
                rtol=2.0 ** -7, atol=1e-6, err_msg=name)


def test_quality_cosines_and_tree_dot_match_reference():
    K = 6
    tree = stacked_tree(K, seed=2)
    agg = {n: v[0] * 0.3 + v[1] * 0.7 for n, v in tree.items()}
    got = fl_round._quality_cosines(to_torch(tree), to_torch(agg))
    exp = ref_round._quality_cosines(
        jax.tree_util.tree_map(jnp.asarray, nested(tree)),
        jax.tree_util.tree_map(jnp.asarray, nested(agg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(
        float(fl_round._tree_dot(to_torch(agg), to_torch(agg))),
        float(ref_round._tree_dot(nested(agg), nested(agg))), rtol=1e-4)


def round_inputs(K, E=2, b=8, seed=0):
    data = make_classification_data("mnist", 400, seed=seed)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 400, size=(K, E, b))
    w = rng.random(K).astype(np.float32)
    mask = np.ones(K, np.float32)
    mask[1] = 0.0
    return data.images[idx], data.labels[idx].astype(np.int64), w, mask


@pytest.mark.parametrize("fused", [False, True])
def test_make_fl_round_matches_reference(fused):
    K = 5
    imgs, labs, w, mask = round_inputs(K)
    jtree, params = ref_params()
    kw = dict(local_lr=0.1, local_steps=2, server_lr=1.0)
    rfn = ref_round.make_fl_round(
        lambda p, b: jcnn.loss_fn(jcnn.MNIST_CNN, p, b), fused_quality=fused,
        **kw)
    jout, jinfo = rfn(jtree, {"images": jnp.asarray(imgs),
                              "labels": jnp.asarray(labs.astype(np.int32))},
                      jnp.asarray(w), jnp.asarray(mask))
    batches = {"images": torch.as_tensor(imgs), "labels": torch.as_tensor(labs)}
    loss = lambda p, b: cnn.loss_fn(cnn.MNIST_CNN, p, b)
    outs = {}
    for use_kernel in (False, True):
        fn = fl_round.make_fl_round(loss, use_agg_kernel=use_kernel,
                                    fused_quality=fused, **kw)
        out, info = fn(params, batches, torch.as_tensor(w),
                       torch.as_tensor(mask))
        outs[use_kernel] = (out, info)
        for name, v in out.items():
            layer, leaf = name.split(".")
            np.testing.assert_allclose(v.numpy(), np.asarray(jout[layer][leaf]),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(info["q_values"].numpy(),
                                   np.asarray(jinfo["q_values"]), atol=1e-4)
        assert info["q_values"][1] == 0.0
        for key in ("client_losses", "mean_loss"):
            np.testing.assert_allclose(info[key].numpy(), np.asarray(jinfo[key]),
                                       rtol=1e-4, atol=1e-5)
    if fused:      # use_agg_kernel only picks the two-pass aggregate
        for n in outs[False][0]:
            assert torch.equal(outs[False][0][n], outs[True][0][n])


def test_two_pass_and_fused_rounds_agree():
    K = 4
    imgs, labs, w, mask = round_inputs(K, seed=3)
    _, params = ref_params()
    batches = {"images": torch.as_tensor(imgs), "labels": torch.as_tensor(labs)}
    loss = lambda p, b: cnn.loss_fn(cnn.MNIST_CNN, p, b)
    runs = [fl_round.make_fl_round(loss, local_lr=0.1, fused_quality=f)(
        params, batches, torch.as_tensor(w), torch.as_tensor(mask))
        for f in (False, True)]
    (pa, ia), (pb, ib) = runs
    for n in pa:
        torch.testing.assert_close(pa[n], pb[n], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(ia["q_values"], ib["q_values"], rtol=0,
                               atol=1e-4)


def test_two_pass_scan_matches_reference():
    data = make_classification_data("mnist", 300, seed=SEED)
    parts = partition_labels(data.labels, 8, "type2", 10, seed=SEED)
    rows = np.array([[0, 3, 5, 0], [1, 2, 6, 7], [4, 0, 0, 0]], np.int64)
    active = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0]], np.float32)
    weights = active * np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    round_ids = np.array([2, 3, 4])
    kw = dict(local_lr=0.1, local_steps=2, batch_size=8, server_lr=1.0,
              dropout_rate=0.3, fused_quality=False)
    jtree, params = ref_params()
    jfn = ref_round.make_fl_rounds_scan(
        lambda p, b: jcnn.loss_fn(jcnn.MNIST_CNN, p, b), **kw)
    jout, jinfo = jfn(jtree, ref_dd.DeviceDataset.stage(
        ref_make_data("mnist", 300, seed=SEED), ref_partition(
            data.labels, 8, "type2", 10, seed=SEED)),
        {"rows": jnp.asarray(rows, jnp.int32),
         "weights": jnp.asarray(weights), "active": jnp.asarray(active),
         "round_ids": jnp.asarray(round_ids, jnp.int32)},
        jax.random.PRNGKey(SEED))
    sched = {"rows": torch.as_tensor(rows), "weights": torch.as_tensor(weights),
             "active": torch.as_tensor(active),
             "round_ids": torch.as_tensor(round_ids)}
    dd = device_data.DeviceDataset.stage(data, parts, "cpu")
    loss = lambda p, b: cnn.loss_fn(cnn.MNIST_CNN, p, b)
    for use_kernel in (False, True):
        out, info = fl_round.make_fl_rounds_scan(
            loss, use_agg_kernel=use_kernel, **kw)(params, dd, sched,
                                                    trandom.prng_key(SEED))
        np.testing.assert_array_equal(info["masks"].numpy(),
                                      np.asarray(jinfo["masks"]))
        for name, v in out.items():
            layer, leaf = name.split(".")
            np.testing.assert_allclose(v.numpy(), np.asarray(jout[layer][leaf]),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(info["q_values"].numpy(),
                                   np.asarray(jinfo["q_values"]), atol=1e-4)
        np.testing.assert_allclose(info["mean_loss"].numpy(),
                                   np.asarray(jinfo["mean_loss"]), rtol=1e-4)


@pytest.mark.parametrize("impl", ["reference", "fast", "auto"])
def test_cnn_impl_matches_reference(impl):
    cfg, jcfg = cnn.CIFAR_CNN, jcnn.CIFAR_CNN
    tree = jcnn.init_params(jcfg, jax.random.PRNGKey(1))
    params = cnn.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 6)
    got = cnn.forward(cfg, params, torch.as_tensor(x), impl=impl)
    exp = jcnn.forward(jcfg, tree, jnp.asarray(x), impl=impl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               rtol=1e-5, atol=1e-5)
    g = torch.func.grad(lambda p: cnn.loss_fn(
        cfg, p, {"images": torch.as_tensor(x),
                 "labels": torch.as_tensor(y)}, impl=impl)[0])(params)
    jg = jax.grad(lambda p: jcnn.loss_fn(
        jcfg, p, {"images": jnp.asarray(x), "labels": jnp.asarray(y)},
        impl=impl)[0])(tree)
    for name, v in g.items():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(v.numpy(), np.asarray(jg[layer][leaf]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_cnn_auto_resolves_by_device():
    cpu = torch.device("cpu")
    assert cnn.resolve_impl("auto", cpu) == "fast"
    assert cnn.resolve_impl("auto", torch.device("cuda")) == "reference"
    assert cnn.resolve_impl("reference", cpu) == "reference"
    with pytest.raises(ValueError, match="impl"):
        cnn.resolve_impl("im2col", cpu)


def test_fl_classification_sim_matches_reference():
    data = make_classification_data("mnist", 400, seed=2)
    parts = partition_labels(data.labels, 8, "type2", 10, seed=2)
    kw = dict(dropout_rate=0.3, batch_size=8, local_steps=2, eval_every=2)
    rsim = ref_sim.FLClassificationSim(jcnn.MNIST_CNN, data, parts, data,
                                       ref_sim.SimConfig(**kw))
    psim = simulation.FLClassificationSim(cnn.MNIST_CNN, data, parts, data,
                                          simulation.SimConfig(**kw),
                                          device="cpu")
    psim.params = cnn.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             rsim.params))
    rounds = [(0, [0, 3, 5]), (1, [1, 2, 6, 7]), (2, [4, 0])]
    for rnd, subset in rounds:
        K = len(subset)
        (mu, pu), (rmu, rpu) = psim._round_draws(rnd, K), rsim._round_draws(rnd, K)
        np.testing.assert_array_equal(mu.numpy(), rmu)
        np.testing.assert_array_equal(pu, rpu)
        got, exp = psim._client_batches(subset, pu), \
            rsim._client_batches(subset, rpu)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]))
        w = np.full(K, 1.0 / K)
        (m, q, met), (rm, rq, rmet) = psim(rnd, subset, w), rsim(rnd, subset, w)
        np.testing.assert_array_equal(m, rm)
        np.testing.assert_allclose(q, rq, atol=1e-4)
        np.testing.assert_allclose(met["loss"], rmet["loss"], rtol=1e-4)
        assert ("accuracy" in met) == ("accuracy" in rmet)
    for name, v in psim.params.items():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(v.numpy(), np.asarray(rsim.params[layer][leaf]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert psim.trainer is psim and psim.accepts_arrivals


@pytest.fixture
def reference_init(monkeypatch):
    """The port's trainers start from the reference's initial params."""
    def init(cfg, generator, device=None):
        jcfg = {c.name: c for c in (jcnn.MNIST_CNN, jcnn.CIFAR_CNN)}[cfg.name]
        tree = jcnn.init_params(jcfg,
                                jax.random.PRNGKey(generator.initial_seed()))
        params = cnn.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        return {k: v.to(device) for k, v in params.items()}
    monkeypatch.setattr(cnn, "init_params", init)


def test_run_fl_experiment_host_plane_matches_reference(reference_init):
    run = dict(n_clients=12, rounds=5, n_train=600, n_test=200,
               subset_size=4, subset_delta=1, seed=0)
    sim = dict(dropout_rate=0.2, eval_every=2, batch_size=8)
    port = simulation.run_fl_experiment("mnist", "type2",
                                        sim=simulation.SimConfig(**sim),
                                        device="cpu", **run)
    ref = ref_sim.run_fl_experiment("mnist", "type2",
                                    sim=ref_sim.SimConfig(**sim), **run)
    ps, rs = port["state"], ref["state"]
    assert ps.task.round_chunk == rs.task.round_chunk == 1
    assert ps.pool_selected.selected == rs.pool_selected.selected
    assert [s.subsets for s in ps.schedules] == [s.subsets for s in rs.schedules]
    assert len(ps.rounds) == len(rs.rounds) == run["rounds"]
    for a, b in zip(ps.rounds, rs.rounds):
        assert (a.period, a.round_index, a.subset) == \
            (b.period, b.round_index, b.subset)
        np.testing.assert_array_equal(a.weights, b.weights)
        np.testing.assert_allclose(a.metrics["loss"], b.metrics["loss"],
                                   rtol=1e-4)
        if "accuracy" in b.metrics:
            assert abs(a.metrics["accuracy"] - b.metrics["accuracy"]) \
                <= 1.5 / run["n_test"]
    ta, tb = ps.tracker.to_arrays(), rs.tracker.to_arrays()
    for k in ta:
        if k == "q":
            np.testing.assert_allclose(ta[k], tb[k], atol=1e-4)
        else:
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def test_host_plane_refuses_the_device_plane_options():
    for kw in ({"compression": "int8"}, {"server_opt": "fedadam"}):
        with pytest.raises(ValueError, match="device data plane"):
            simulation.run_fl_experiment("mnist", "type2", device="cpu", **kw)
    with pytest.raises(ValueError, match="data_plane"):
        simulation.run_fl_experiment("mnist", "type2", data_plane="disk",
                                     device="cpu")


def test_rounds_pin_conv_numerics_and_restore_the_callers():
    """The library pins cuDNN (full f32, deterministic, no autotune)
    inside its rounds and evals, and leaves the caller's flags as it
    found them."""
    seen = []

    def loss(p, b):
        seen.append((torch.backends.cudnn.enabled,
                     torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        return cnn.loss_fn(cnn.MNIST_CNN, p, b)

    imgs, labs, w, mask = round_inputs(3, E=1)
    _, params = ref_params()
    flags = torch.backends.cudnn
    before = (flags.enabled, flags.allow_tf32, flags.deterministic,
              flags.benchmark)
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=False, allow_tf32=True):
        caller = (flags.enabled, flags.allow_tf32, flags.deterministic,
                  flags.benchmark)
        fl_round.make_fl_round(loss)(params, {"images": torch.as_tensor(imgs),
                                              "labels": torch.as_tensor(labs)},
                                     torch.as_tensor(w), torch.as_tensor(mask))
        data = make_classification_data("mnist", 200, seed=0)
        parts = partition_labels(data.labels, 4, "type2", 10, seed=0)
        for cls in (simulation.FLClassificationSim, simulation.DeviceFLSim):
            s = cls(cnn.MNIST_CNN, data, parts, data,
                    simulation.SimConfig(batch_size=4, eval_every=1),
                    device="cpu")
            s.run_rounds(0, [[0, 1]], [np.array([0.5, 0.5])])
            assert (flags.enabled, flags.allow_tf32, flags.deterministic,
                    flags.benchmark) == caller
    assert seen and all(s == (True, False, True, False) for s in seen)
    assert (flags.enabled, flags.allow_tf32, flags.deterministic,
            flags.benchmark) == before
