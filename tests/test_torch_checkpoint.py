"""The port's checkpoint files against the JAX package's, on the CPU.

- The codec: the port's msgpack bytes equal ``msgpack.packb(payload,
  use_bin_type=True)``, and it reads them back equal (exact).
- Files cross both ways: a ``TaskState`` of formats 1-4 saved by either
  package loads in the other, zstd-compressed and raw (``zstandard``
  patched to ``None`` in both), into equal arrays (exact: both packages
  hold the same host state), and the two packages write the same bytes.
- Leaves round-trip bit for bit: bf16 (through its uint16 bits), f64 and
  int64.
- Resume: the federated LM task checkpointed mid-run with its trainer
  state (int8 and top-k + int8 codecs) repeats the uninterrupted rounds
  and ends at the same adapters, bit for bit; a FedYogi server's
  moments ride the checkpoint exactly; ``save_state`` refuses an
  in-flight chunk unless asked to flush it. These mirror the JAX
  package's own tests (tests/test_compression.py, tests/test_lifecycle.py).
- Trainer state: the port's ``DeviceFLSim`` exports the reference's keys,
  and imports the reference trainer's export exactly.
"""
import os

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.checkpoint import checkpoint as ref_ckpt_mod
from repro.core import FLServiceProvider as RefProvider
from repro.core import lifecycle as ref_life
from repro.core import random_profiles as ref_profiles
from repro.fl import simulation as ref_sim
from repro_torch import checkpoint
from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.checkpoint import msgpack_codec
from repro_torch.core import FLServiceProvider, lifecycle
from repro_torch.data.synthetic import make_classification_data
from repro_torch.fl import simulation
from repro_torch.fl.partition import partition_labels
from repro_torch.fl.transformer_task import make_transformer_fl


# ---------------------------------------------------------------------------
# the msgpack codec
# ---------------------------------------------------------------------------

def _payload(n_leaves, key_len, data_len, dims):
    return {"keys": ["k" * key_len + str(i) for i in range(n_leaves)],
            "leaves": [{"dtype": "float32", "shape": list(dims),
                        "data": bytes(range(256)) * (data_len // 256)
                        + b"x" * (data_len % 256)}
                       for _ in range(n_leaves)]}


@pytest.mark.parametrize("n_leaves,key_len,data_len,dims", [
    (0, 0, 0, ()), (1, 0, 0, (0,)), (15, 30, 255, (127, 128)),
    (16, 31, 256, (255, 256)), (17, 255, 65535, (65535, 65536)),
    (3, 256, 65536, (2 ** 32 - 1, 2 ** 32)), (2, 70000, 70000, (2 ** 40,))])
def test_codec_bytes_equal_msgpack(n_leaves, key_len, data_len, dims):
    payload = _payload(n_leaves, key_len, data_len, dims)
    packed = msgpack_codec.packb(payload)
    assert packed == msgpack.packb(payload, use_bin_type=True)
    assert msgpack_codec.unpackb(packed) == msgpack.unpackb(packed,
                                                            raw=False)


def test_codec_reads_long_arrays_and_maps_and_refuses_the_rest():
    obj = {str(i): list(range(i)) for i in range(40)}
    obj["long"] = list(range(70000))
    assert msgpack_codec.unpackb(msgpack.packb(obj)) == obj
    with pytest.raises(ValueError, match="subset"):
        msgpack_codec.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError, match="after"):
        msgpack_codec.unpackb(msgpack.packb(1) + b"\x01")
    for bad in (1.5, None, True):
        with pytest.raises(TypeError):
            msgpack_codec.packb({"x": bad})
    with pytest.raises(ValueError, match="negative"):
        msgpack_codec.packb([-1])


# ---------------------------------------------------------------------------
# TaskState files, both ways
# ---------------------------------------------------------------------------

def _stub(rnd, subset, weights):
    q = np.linspace(0.5, 0.9, len(subset))
    return np.ones(len(subset), bool), q, {"round": rnd}


def _reference_arrays(fmt: int) -> dict:
    """A settled reference TaskState mid-period (pool, schedule and
    tracker present) as the arrays a format-``fmt`` file holds, built as
    tests/test_lifecycle.py builds the older formats."""
    sp = RefProvider(ref_profiles(40, 10, np.random.default_rng(3)))
    task = ref_life.TaskRequest(budget=400.0, n_star=10, subset_size=4,
                                subset_delta=1, max_periods=3, seed=3,
                                compression="topk:0.05+int8@chunk=128",
                                scheduling_policy="fair_ema")
    state = ref_life.submit(sp, task)
    for _ in range(3):
        state, _ = ref_life.step(sp, state, _stub)
    state.trainer_state = {"params/attn/wq/a": np.arange(6, dtype=np.float32),
                           "opt/count": np.array(3, dtype=np.int32),
                           "opt/v/x": np.linspace(0, 1, 4)}
    arrays = state.to_arrays()
    arrays["format"] = np.array([fmt], dtype=np.int64)
    if fmt < 4:
        del arrays["task/compression"]
        arrays = {k: v for k, v in arrays.items() if not k.startswith("trn/")}
    if fmt < 2:
        del arrays["task/selection_policy"]
        del arrays["task/scheduling_policy"]
    return arrays


def _assert_same_arrays(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(params=["zstd", "raw"])
def compressed(request, monkeypatch):
    if request.param == "raw":
        monkeypatch.setattr(ckpt_mod, "zstandard", None)
        monkeypatch.setattr(ref_ckpt_mod, "zstandard", None)
    elif ckpt_mod.zstandard is None or ref_ckpt_mod.zstandard is None:
        pytest.skip("zstandard is not importable")
    return request.param


@pytest.mark.parametrize("fmt", [1, 2, 3, 4])
def test_reference_file_loads_in_port(fmt, compressed, tmp_path):
    path = str(tmp_path / "ref.ckpt")
    ref_ckpt.save(path, _reference_arrays(fmt))
    with open(path, "rb") as f:
        assert (f.read(4) == ckpt_mod._ZSTD_MAGIC) == (compressed == "zstd")
    got = lifecycle.load_state(path)
    want = ref_life.load_state(path)
    _assert_same_arrays(got.to_arrays(), want.to_arrays())
    assert got.task.compression == want.task.compression
    assert (got.trainer_state != {}) == (fmt == 4)


@pytest.mark.parametrize("fmt", [1, 2, 3, 4])
def test_port_file_loads_in_reference(fmt, compressed, tmp_path):
    arrays = lifecycle.TaskState.from_arrays(_reference_arrays(fmt))
    path = str(tmp_path / "port.ckpt")
    assert lifecycle.save_state(path, arrays) == []
    back = ref_life.load_state(path)
    _assert_same_arrays(back.to_arrays(), arrays.to_arrays())
    # the same arrays make the same file in either package
    ref_path = str(tmp_path / "ref.ckpt")
    ref_ckpt.save(ref_path, arrays.to_arrays())
    with open(path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()


def test_raw_payload_is_msgpack_packb(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt_mod, "zstandard", None)
    tree = {"b": np.arange(5, dtype=np.int64),
            "a": {"y": torch.ones(2, 3), "x": [np.float64(2.5), 7]}}
    path = str(tmp_path / "t.ckpt")
    checkpoint.save(path, tree)
    keys, leaves = ckpt_mod._paths(tree)
    assert keys == ["a/x/0", "a/x/1", "a/y", "b"]
    payload = {"keys": keys,
               "leaves": [ckpt_mod._leaf_to_record(x) for x in leaves]}
    with open(path, "rb") as f:
        assert f.read() == msgpack.packb(payload, use_bin_type=True)
    # the keys are jax.tree_util's, letter for letter
    ref_keys, _, _ = ref_ckpt_mod._paths(
        jax.tree_util.tree_map(np.asarray, {"b": np.arange(5), "a": {
            "y": np.ones((2, 3)), "x": [np.float64(2.5), 7]}}))
    assert ref_keys == keys


def test_zstd_file_without_zstandard_raises(tmp_path, monkeypatch):
    if ckpt_mod.zstandard is None:
        pytest.skip("zstandard is not importable")
    path = str(tmp_path / "z.ckpt")
    checkpoint.save(path, {"x": np.ones(3)})
    monkeypatch.setattr(ckpt_mod, "zstandard", None)
    with pytest.raises(ModuleNotFoundError, match="zstandard"):
        checkpoint.restore_dict(path)


# ---------------------------------------------------------------------------
# leaves bit for bit
# ---------------------------------------------------------------------------

def test_bf16_f64_int64_leaves_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    bf = torch.randn(3, 5, generator=g).to(torch.bfloat16)
    bf[0, :3] = torch.tensor([float("nan"), float("inf"), -0.0])
    f64 = np.random.default_rng(1).standard_normal(7) * 1e300
    i64 = np.array([2 ** 62 + 1, -2 ** 63, 5], dtype=np.int64)
    tree = {"bf": bf, "f64": torch.from_numpy(f64), "i64": i64}
    path = str(tmp_path / "leaves.ckpt")
    checkpoint.save(path, tree)
    flat = checkpoint.restore_dict(path)
    assert flat["bf"].dtype == torch.bfloat16
    assert torch.equal(flat["bf"].view(torch.int16), bf.view(torch.int16))
    assert flat["f64"].dtype == np.float64 and flat["i64"].dtype == np.int64
    np.testing.assert_array_equal(flat["f64"], f64)
    np.testing.assert_array_equal(flat["i64"], i64)
    back = checkpoint.restore(path, tree)
    assert torch.equal(back["bf"].view(torch.int16), bf.view(torch.int16))
    assert back["f64"].dtype == torch.float64
    np.testing.assert_array_equal(back["f64"].numpy(), f64)
    assert back["i64"].dtype == torch.int64
    np.testing.assert_array_equal(back["i64"].numpy(), i64)
    # the reference reads the same bits (bf16 through ml_dtypes)
    ref = ref_ckpt.restore_dict(path)
    np.testing.assert_array_equal(ref["bf"].view(np.uint16),
                                  bf.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(ref["f64"], f64)
    np.testing.assert_array_equal(ref["i64"], i64)


def test_restore_checks_keys_and_shapes(tmp_path):
    path = str(tmp_path / "t.ckpt")
    checkpoint.save(path, {"a": torch.zeros(2), "b": torch.ones(3)})
    with pytest.raises(KeyError, match="missing"):
        checkpoint.restore(path, {"c": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(path, {"a": torch.zeros(3)})
    back = checkpoint.restore(path, {"a": torch.zeros(2)})
    assert list(back) == ["a"] and torch.equal(back["a"], torch.zeros(2))


def test_restore_warns_once_per_narrowed_key_set(tmp_path, monkeypatch):
    """torch holds every stored dtype, so nothing narrows by itself; a
    leaf forced to f32 shows the warning fires once per key set."""
    import warnings
    path = str(tmp_path / "t.ckpt")
    checkpoint.save(path, {"a": np.arange(3, dtype=np.float64),
                           "b": np.ones(2, np.float32)})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = checkpoint.restore(path, {"a": np.zeros(3), "b": np.zeros(2)})
        assert back["a"].dtype == torch.float64
    to_leaf = ckpt_mod._record_to_leaf
    monkeypatch.setattr(ckpt_mod, "_record_to_leaf",
                        lambda rec, like=None: to_leaf(rec, like).float())
    checkpoint.reset_narrowing_warnings()
    like = {"a": torch.zeros(3), "b": torch.zeros(2)}
    with pytest.warns(UserWarning, match="'a': float64 -> float32"):
        checkpoint.restore(path, like)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        checkpoint.restore(path, like)


def test_checkpoint_manager_rotates_and_restores_latest(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpts"), keep=2)
    for step in (1, 5, 9):
        mgr.save(step, {"w": torch.full((2,), float(step))})
    assert mgr.steps() == [5, 9]
    step, tree = mgr.restore_latest({"w": torch.zeros(2)})
    assert step == 9 and torch.equal(tree["w"], torch.full((2,), 9.0))
    # the reference's manager reads the port's directory
    ref_step, ref_tree = ref_ckpt.CheckpointManager(
        str(tmp_path / "ckpts")).restore_latest({"w": np.zeros(2)})
    assert ref_step == 9
    np.testing.assert_array_equal(np.asarray(ref_tree["w"]), [9.0, 9.0])


# ---------------------------------------------------------------------------
# resume (mirrors tests/test_compression.py and tests/test_lifecycle.py)
# ---------------------------------------------------------------------------

def _bundle(compression=None, server_opt=None):
    return make_transformer_fl(n_clients=10, n_train=100, n_test=30,
                               seq_len=8, compression=compression,
                               server_opt=server_opt, device="cpu")


def _task(compression=None, max_rounds=4, round_chunk=2):
    return lifecycle.TaskRequest(budget=200.0, subset_size=4, subset_delta=2,
                                 x_star=2, max_periods=3,
                                 max_rounds=max_rounds,
                                 round_chunk=round_chunk, seed=0,
                                 compression=compression)


@pytest.mark.parametrize("comp", ["int8", "topk:0.25+int8"])
def test_compressed_resume_reproduces_rounds(comp, tmp_path):
    b1 = _bundle(compression=comp)
    p1 = FLServiceProvider(b1["pool"])
    s1 = lifecycle.submit(p1, _task(comp, max_rounds=6, round_chunk=1))
    s1, ref_ev = lifecycle.drain(p1, s1, b1["trainer"])

    b2 = _bundle(compression=comp)
    p2 = FLServiceProvider(b2["pool"])
    s2 = lifecycle.submit(p2, _task(comp, max_rounds=6, round_chunk=1))
    got = []
    while len(got) < 3:
        s2, ev = lifecycle.step(p2, s2, b2["trainer"])
        got.extend(ev)
    path = os.path.join(tmp_path, "mid.ckpt")
    got += lifecycle.save_state(path, s2, flush=True, trainer=b2["trainer"])

    s3 = lifecycle.load_state(path)
    assert s3.task.compression == comp
    b3 = _bundle(compression=comp)
    assert lifecycle.restore_trainer_state(s3, b3["trainer"])
    p3 = FLServiceProvider(b3["pool"])
    s3, post = lifecycle.drain(p3, s3, b3["trainer"])

    rounds = got + post
    assert len(rounds) == len(ref_ev)
    for a, b in zip(rounds, ref_ev):
        assert (a.period, a.round_index, a.subset) == \
            (b.period, b.round_index, b.subset)
        assert a.nid == b.nid
    assert sorted(b1["trainer"].params) == sorted(b3["trainer"].params)
    for k, x in b1["trainer"].params.items():
        assert torch.equal(x, b3["trainer"].params[k]), k


def test_server_opt_state_rides_checkpoint(tmp_path):
    b = _bundle(compression="int8", server_opt="fedyogi")
    sp = FLServiceProvider(b["pool"])
    st = lifecycle.submit(sp, _task(compression="int8"))
    st, _ = lifecycle.drain(sp, st, b["trainer"])
    path = os.path.join(tmp_path, "opt.ckpt")
    lifecycle.save_state(path, st, trainer=b["trainer"])
    back = lifecycle.load_state(path)
    assert "opt/count" in back.trainer_state
    b2 = _bundle(compression="int8", server_opt="fedyogi")
    assert lifecycle.restore_trainer_state(back, b2["trainer"])
    want = checkpoint.tree_to_arrays(b["trainer"].opt_state)
    got = checkpoint.tree_to_arrays(b2["trainer"].opt_state)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype
        np.testing.assert_array_equal(want[k], got[k])
    assert int(b2["trainer"].opt_state["count"]) == 4


def test_save_state_refuses_in_flight_by_default(tmp_path):
    b = _bundle()
    sp = FLServiceProvider(b["pool"])
    state = lifecycle.submit(sp, _task())
    state, _ = lifecycle.step(sp, state, b["trainer"])
    state = lifecycle.dispatch(sp, state, b["trainer"])
    path = os.path.join(tmp_path, "inflight.ckpt")
    with pytest.raises(lifecycle.InFlightError):
        lifecycle.save_state(path, state)
    assert not os.path.exists(path)
    flushed = lifecycle.save_state(path, state, flush=True)
    assert flushed and state.pending is None
    back = lifecycle.load_state(path)
    assert back.global_round == state.global_round


# ---------------------------------------------------------------------------
# trainer state keys cross between the packages
# ---------------------------------------------------------------------------

def test_device_trainer_state_crosses_packages():
    data = make_classification_data("mnist", 120, seed=0)
    test = make_classification_data("mnist", 20, seed=1)
    parts = partition_labels(data.labels, 4, "type1", data.num_classes,
                             seed=0)
    sim = simulation.SimConfig(batch_size=4, local_steps=1, seed=0)
    port = simulation.DeviceFLSim(simulation.cnn.MNIST_CNN, data, parts, test,
                                  sim, server_opt="fedadam", device="cpu")
    ref = ref_sim.DeviceFLSim(ref_sim.cnn.MNIST_CNN, data, parts, test, sim,
                              server_opt="fedadam")
    ref_arrays = ref.export_state()
    assert sorted(port.export_state()) == sorted(ref_arrays)
    order = list(port.params)
    port.import_state(ref_arrays)
    assert list(port.params) == order        # the trainer's own key order
    back = port.export_state()
    for k, v in ref_arrays.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
