"""Port parity for the whole slice: stage 1, stage 2, the task
lifecycle and the device round plane, driven the way
``run_fl_experiment(..., data_plane="device")`` drives them, on
MNIST-size data (12 clients, 6 rounds, 600 samples). Also the entry
points' device rule and the port's import hygiene.

Control-plane outputs (pools, subsets, weights, Nids, returned masks)
must be equal. Training outputs differ only by f32 summation order
(and by the reference CNN's im2col lowering off-TPU, ≤1.25e-6 on the
logits): losses rtol 1e-4, q-values atol 1e-4, accuracies within one
and a half test samples (an argmax near a tie may flip).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.fl import simulation as ref_sim
from repro.models import cnn as jcnn
from repro_torch.core import FLServiceProvider, TaskRequest, lifecycle
from repro_torch.data.synthetic import make_classification_data
from repro_torch.fl import simulation
from repro_torch.fl.partition import partition_labels
from repro_torch.models import cnn

ROOT = Path(__file__).resolve().parents[1]
SIM_KW = dict(dropout_rate=0.2, eval_every=2, batch_size=8)
RUN = dict(n_clients=12, rounds=6, n_train=600, n_test=200, subset_size=4,
           subset_delta=1, round_chunk=3, seed=0)
N_EVAL = RUN["n_test"]


@pytest.fixture(scope="module")
def ref_run():
    return ref_sim.run_fl_experiment(
        "mnist", "type2", sim=ref_sim.SimConfig(**SIM_KW),
        data_plane="device", **RUN)


def port_slice_with_ref_params():
    """The body of the port's run_fl_experiment, with the reference's
    initial parameters carried into the port's trainer."""
    sim = simulation.SimConfig(**SIM_KW)
    seed, n_train = RUN["seed"], RUN["n_train"]
    full = make_classification_data("mnist", n_train + RUN["n_test"], seed=seed)
    data = full.subset(np.arange(n_train))
    test = full.subset(np.arange(n_train, n_train + RUN["n_test"]))
    parts = partition_labels(data.labels, RUN["n_clients"], "type2",
                             data.num_classes, seed=seed)
    pool = simulation.pool_from_partition(data.labels, parts,
                                          data.num_classes, seed=seed)
    provider = FLServiceProvider(pool)
    simul = simulation.DeviceFLSim(
        cnn.MNIST_CNN, data, parts, test, sim,
        pad_subset_to=RUN["subset_size"] + RUN["subset_delta"], device="cpu")
    simul.params = cnn.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.MNIST_CNN,
                                     jax.random.PRNGKey(sim.seed))))
    task = TaskRequest(budget=1e9, n_star=RUN["n_clients"],
                       subset_size=RUN["subset_size"],
                       subset_delta=RUN["subset_delta"], x_star=3,
                       max_periods=10_000, scheduler="mkp", seed=seed,
                       round_chunk=RUN["round_chunk"],
                       max_rounds=RUN["rounds"])
    state = lifecycle.submit(provider, task)
    state, _ = lifecycle.drain(
        provider, state, simul,
        stop_fn=lambda m: m["round"] + 1 >= RUN["rounds"])
    return {"history": simul.history, "state": state,
            "final_accuracy": simul.evaluate()}


def assert_accuracy_close(a, b):
    assert abs(a - b) <= 1.5 / N_EVAL, (a, b)


def test_slice_matches_reference(ref_run):
    port = port_slice_with_ref_params()
    rs, ps = ref_run["state"], port["state"]
    assert rs.pool_selected.selected == ps.pool_selected.selected
    assert len(rs.rounds) == len(ps.rounds) == RUN["rounds"]
    for a, b in zip(rs.rounds, ps.rounds):
        assert (a.period, a.round_index, a.subset) == \
            (b.period, b.round_index, b.subset)
        np.testing.assert_array_equal(a.weights, b.weights)
        assert a.nid == b.nid
        np.testing.assert_allclose(b.metrics["loss"], a.metrics["loss"],
                                   rtol=1e-4)
        assert ("accuracy" in a.metrics) == ("accuracy" in b.metrics)
        if "accuracy" in a.metrics:
            assert_accuracy_close(a.metrics["accuracy"], b.metrics["accuracy"])
    ta, tb = rs.tracker.to_arrays(), ps.tracker.to_arrays()
    assert sorted(ta) == sorted(tb)
    for k in ta:
        if k == "q":
            np.testing.assert_allclose(tb[k], ta[k], atol=1e-4)
        else:                      # ids, returned masks, counts, meta
            np.testing.assert_array_equal(tb[k], ta[k], err_msg=k)
    assert_accuracy_close(ref_run["final_accuracy"], port["final_accuracy"])


def test_run_fl_experiment_selects_like_reference(ref_run):
    port = simulation.run_fl_experiment(
        "mnist", "type2", sim=simulation.SimConfig(**SIM_KW),
        data_plane="device", device="cpu", **RUN)
    rs, ps = ref_run["state"], port["state"]
    assert rs.pool_selected.selected == ps.pool_selected.selected
    assert rs.schedules[0].subsets == ps.schedules[0].subsets
    assert [e.subset for e in rs.rounds[:3]] == \
        [e.subset for e in ps.rounds[:3]]
    assert len(port["history"]) == RUN["rounds"]
    assert all(np.isfinite(h["loss"]) for h in port["history"])
    assert 0.0 <= port["final_accuracy"] <= 1.0


def test_entry_points_default_to_cuda():
    data = make_classification_data("mnist", 40, seed=0)
    parts = partition_labels(data.labels, 4, "type2", 10, seed=0)
    if torch.cuda.is_available():
        sim = simulation.DeviceFLSim(cnn.MNIST_CNN, data, parts, data)
        assert sim.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulation.DeviceFLSim(cnn.MNIST_CNN, data, parts, data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulation.run_fl_experiment("mnist", "type2", n_clients=4,
                                     n_train=40, n_test=10)


def test_unported_paths_raise(tmp_path):
    """Nothing of the slice is cut any more: a mesh builds the sharded
    trainer (tests/test_torch_placement.py holds it to the reference),
    and a mesh with compression or a server optimizer is refused as the
    reference refuses it. Compression and server optimizers alone build
    a trainer, and the checkpoint files save and load.
    (The host-loop plane, fault plans and arrival masks run:
    tests/test_torch_host_plane.py and tests/test_torch_faults.py; the
    checkpoint files: tests/test_torch_checkpoint.py.)"""
    from repro_torch.launch.mesh import make_host_mesh
    data = make_classification_data("mnist", 40, seed=0)
    parts = partition_labels(data.labels, 4, "type2", 10, seed=0)
    sharded = simulation.DeviceFLSim(
        cnn.MNIST_CNN, data, parts, data,
        simulation.SimConfig(dropout_rate=0.0),
        mesh=make_host_mesh("cpu", 2))
    assert sharded.device == torch.device("cpu")
    for kw in ({"compression": "int8"}, {"server_opt": "fedadam"}):
        with pytest.raises(ValueError, match="mesh"):
            simulation.DeviceFLSim(cnn.MNIST_CNN, data, parts, data,
                                   mesh=object(), **kw)
    sim = simulation.DeviceFLSim(cnn.MNIST_CNN, data, parts, data,
                                 device="cpu", compression="topk:0.1+int8",
                                 server_opt="fedyogi")
    assert sorted(sim.opt_state) == ["count", "m", "v"]
    state = lifecycle.TaskState(task=lifecycle.TaskRequest(budget=10.0))
    path = str(tmp_path / "state.ckpt")
    assert lifecycle.save_state(path, state) == []
    assert lifecycle.load_state(path).task.budget == 10.0


_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_never_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "examples").glob("*_torch.py"))
    for f in files:
        assert not _IMPORT_RE.search(f.read_text()), f
    blocker = (
        "import sys\n"
        "class B:\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'repro'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        "import repro_torch, repro_torch.core, repro_torch.random\n"
        "import repro_torch.fl.simulation, repro_torch.kernels.ops\n"
        "import repro_torch.models.cnn, repro_torch.device\n"
        "import repro_torch.core.device_pool, repro_torch.core.engine\n"
        "import repro_torch.kernels.build, repro_torch.kernels.segmented_topk\n"
        "import repro_torch.kernels.mkp_utility\n"
        "import repro_torch.kernels.compression, repro_torch.fl.compression\n"
        "import repro_torch.optim, repro_torch.optim.schedules\n"
        "import repro_torch.configs, repro_torch.models.transformer\n"
        "import repro_torch.models.layers, repro_torch.launch.serve\n"
        "import repro_torch.kernels.rmsnorm, repro_torch.kernels.swiglu\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.models.ssm, repro_torch.kernels.mlstm_scan\n"
        "import repro_torch.models.moe\n"
        "import repro_torch.core.faults, repro_torch.core.workload\n"
        "import repro_torch.core.driver, repro_torch.core.telemetry\n"
        "repro_torch.configs.all_configs()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", blocker], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
