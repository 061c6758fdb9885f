"""The port's dry-run (``repro_torch.launch.dryrun``): a DTensor trace
on a fake process group, held to its own contract and to counts that
need no reference output.

The reference's dry-run is no oracle: its five small-mesh runs
(tests/test_dryrun_small.py) fail on this JAX version at the embedding
lookup. So the port's is held to:

- the contract of the reference's test: on a 4x2 mesh, ``run_one`` of a
  reduced config of each family (SmolLM, Qwen1.5-MoE, Hymba, xLSTM,
  Whisper) at ``train_4k`` is ``ok`` with flops > 0 and a bottleneck
  named, and leaves no process group behind; the CLI writes the
  reference's artifact name for the full SmolLM-360M config;
- the flops of a 1x1 trace equal ``FlopCounterMode`` over a real CPU run
  of the same step, exactly; the per-device flops of a data-parallel
  train step on 8x1 are 1/8 of 1x1's within 1 %; for a homogeneous
  stack the traced flops are linear in depth, f(3) = f(1) + 2 (f(2) -
  f(1)), exactly (the identity the reference's probe correction
  assumes);
- on the multi-pod mesh, where pod and data are traced as one mesh dim,
  the per-device flops of SmolLM's train step are half those of one
  pod within 1 %;
- an all-gather of bf16[16, 4096, 384] counts the bytes the reference's
  HLO parser counts for that shape;
- no op is replicated behind the count's back: an op DTensor cannot
  run raises, ``log_sigmoid_backward`` runs on its shards by the
  strategy the trace registers, the MoE dispatch's scatter-add reduces
  partial sums instead of gathering the tokens, and the live bytes
  follow each storage until it is freed.

The flop checks shrink ``train_4k`` to 32 tokens x 8 sequences (a
shape tuple in place of its name) so the real CPU run is small, and
take remat off;
the reduced configs scan in chunks of 1,024 (a trace runs each chunk's
ops: fewer chunks, a faster trace), and the contract's take one layer.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import roofline as JR
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import inputs as I
from repro_torch.launch import trace_compat as C
from repro_torch.launch.mesh import fake_device_mesh, make_production_mesh
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["smollm-360m", "qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m",
            "whisper-large-v3"]


@pytest.fixture(scope="module", autouse=True)
def cli_run(tmp_path_factory):
    """The CLI test's subprocess, started with the module so that it runs
    beside the other tests."""
    out = tmp_path_factory.mktemp("dryrun_cli")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-360m", "--shape", "train_4k", "--mesh", "4,2", "--out",
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=env)
    yield proc, out
    proc.kill()
    proc.communicate()


def reduced(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(**kw),
                               chunk_size=1024)


@pytest.fixture
def one_layer(monkeypatch):
    """``run_one`` on reduced configs of one layer."""
    monkeypatch.setattr(D, "get_config",
                        lambda arch: reduced(arch, num_layers=1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_one_contract_on_a_4x2_mesh(arch, tmp_path, one_layer):
    rec = D.run_one(arch, "train_4k", mesh_shape=(4, 2),
                    out_dir=str(tmp_path), verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert not dist.is_initialized()
    art = json.load(open(tmp_path / f"{arch}__train_4k__4x2.json"))
    assert art["ok"] and art["chips"] == 8
    assert art["roofline"]["flops"] > 0
    assert art["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert art["cost_corrected"] is None
    mem = art["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert mem["alias_size_in_bytes"] == 0
    assert art["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("shape,opt", [("prefill_32k", 0), ("decode_32k", 1),
                                       ("long_500k", 3)])
def test_run_one_serve_shapes(shape, opt, one_layer):
    """The prefill and decode steps trace too, at each ``--opt`` level
    that changes their placement."""
    rec = D.run_one("qwen2-moe-a2.7b", shape, mesh_shape=(4, 2),
                    opt_level=opt, verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == (f"4x2-opt{opt}" if opt else "4x2")
    assert rec["roofline"]["flops"] > 0
    assert rec["note"] == ("window-8192 variant" if shape == "long_500k"
                           else "")


def test_all_gather_counts_the_bytes_of_the_hlo_fixture():
    """bf16[16, 4096, 384] gathered over the model axis of a 4x2 mesh:
    its local output is the whole tensor, as the reference's HLO fixture
    counts ``bf16[16,4096,384] all-gather``."""
    from torch.distributed.tensor import Replicate, Shard

    with fake_device_mesh(make_production_mesh(shape=(4, 2))) as dm:
        x = D.to_dtensor(torch.empty(16, 4096, 384, dtype=torch.bfloat16,
                                     device="meta"), (None, None, "model"),
                         dm)
        assert x.placements == (Replicate(), Shard(2))
        with D.LocalCost() as cost:
            y = x.redistribute(dm, [Replicate(), Replicate()])
        assert y.to_local().shape == (16, 4096, 384)
    assert not dist.is_initialized()
    coll = D.R.collective_bytes(cost.collectives)
    assert coll["counts"]["all-gather"] == 1
    assert coll["bytes"]["all-gather"] == JR.shape_bytes("bf16[16,4096,384]")
    assert coll["total_bytes"] == coll["bytes"]["all-gather"]


TRAIN = (32, 8, "train")       # train_4k's step at 32 tokens x 8 sequences


@pytest.fixture
def small_train():
    """Reduced SmolLM-360M's train step at :data:`TRAIN`, remat off (the
    checks hold either way), and its traced flops by (depth, mesh
    shape), shared by the tests that read them."""
    cfg = I.shape_config(reduced("smollm-360m", num_layers=1), "train_4k",
                         remat=False)

    def flops(layers: int, mesh_shape: tuple) -> float:
        key = (layers, mesh_shape)
        if key not in _TRACED:
            mesh = make_production_mesh(shape=mesh_shape)
            c = dataclasses.replace(cfg, num_layers=layers)
            _TRACED[key] = D.trace_step(c, TRAIN, mesh)["flops"]
        return _TRACED[key]
    return cfg, flops


_TRACED = {}


def test_1x1_flops_equal_flop_counter_over_a_real_cpu_run(small_train):
    cfg, flops = small_train
    S, B, _ = TRAIN
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    step, opt = I.make_train_step(cfg)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 1)),
                           dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "weights": torch.full((B,), 1.0 / B)}
    state = opt.init(params)
    with FlopCounterMode(display=False) as fc:
        _, _, m = step(params, state, batch)
    assert np.isfinite(float(m["loss"]))
    real = fc.get_total_flops()
    assert real > 0
    assert flops(1, (1, 1)) == real


def test_8x1_flops_are_an_eighth_of_1x1(small_train):
    _, flops = small_train
    assert flops(1, (8, 1)) == pytest.approx(flops(1, (1, 1)) / 8,
                                             rel=0.01)


def test_flops_are_linear_in_depth(small_train):
    _, flops = small_train
    f = {L: flops(L, (8, 1)) for L in (1, 2, 3)}
    assert f[2] > f[1] > 0
    assert f[3] == f[1] + 2 * (f[2] - f[1])


def test_multi_pod_flops_are_half_of_one_pod():
    """Two 2x2 pods split the batch twice as far, pod and data one mesh
    dim: each device does half the work of one pod's."""
    pod = (2, 2)
    cfg = I.shape_config(reduced("smollm-360m", num_layers=1), "train_4k")
    shape = (32, 16, "train")
    one = D.trace_step(cfg, shape, make_production_mesh(shape=pod))
    two = D.trace_step(cfg, shape, make_production_mesh(shape=pod,
                                                        multi_pod=True))
    assert one["mesh_dims"] == {"data": pod[0], "model": pod[1]}
    assert two["mesh_dims"] == {"pod+data": 2 * pod[0], "model": pod[1]}
    assert two["flops"] == pytest.approx(one["flops"] / 2, rel=0.01)
    assert one["handled_ops"] == two["handled_ops"]
    assert not dist.is_initialized()


def test_a_spec_of_data_alone_keeps_pod_and_data_apart():
    """long_500k's batch-1 cache splits its sequence over "data" alone,
    so that trace keeps the three mesh dims."""
    mesh = make_production_mesh(shape=(4, 2), multi_pod=True)
    built = D._build_from_cfg(reduced("smollm-360m", num_layers=1),
                              "long_500k", mesh)
    assert not D._merges_data_axes(built[1], built[2])
    train = D._build_from_cfg(reduced("smollm-360m", num_layers=1), TRAIN,
                              mesh)
    assert D._merges_data_axes(train[1], train[2])


def _sharded(dm, shape, spec, dtype=torch.float32):
    return D.to_dtensor(torch.empty(shape, dtype=dtype, device="meta"),
                        spec, dm)


def test_an_op_dtensor_cannot_run_raises():
    """``renorm`` has no sharding strategy: the trace fails there, and
    nothing is gathered first."""
    with fake_device_mesh(make_production_mesh(shape=(4, 2))) as dm:
        x = _sharded(dm, (8, 6), ("data", None))
        with D.LocalCost() as cost, pytest.raises(NotImplementedError,
                                                  match="renorm"):
            torch.renorm(x, 2, 0, 1.0)
    assert cost.collectives == [] and cost.flops == 0
    assert not cost.handled


def test_log_sigmoid_backward_runs_on_its_shards():
    """torch 2.13 has no strategy for ``log_sigmoid_backward``: the one
    the trace registers keeps its inputs' split, so the op is one local
    op on each shard and no collective."""
    D._register_strategies()
    with fake_device_mesh(make_production_mesh(shape=(4, 2))) as dm:
        spec = ("data", None, "model")
        g, x = (_sharded(dm, (8, 6, 4), spec) for _ in range(2))
        buf = _sharded(dm, (8, 6, 4), spec)
        with D.LocalCost() as cost:
            y = torch.ops.aten.log_sigmoid_backward(g, x, buf)
        assert y.placements == x.placements
        assert y.to_local().shape == (2, 6, 2)
    assert cost.collectives == []
    assert cost.bytes == 4 * 2 * 6 * 2 * 4      # 3 inputs + 1 output
    assert not dist.is_initialized()


def test_scatter_add_reduces_partial_sums_not_the_tokens():
    """The MoE dispatch adds token rows, split over "data", into an
    (E, C, d) buffer replicated there: each shard adds its own rows into
    zeros and one all-reduce of the buffer's shard makes it whole; no
    token is gathered."""
    E, C, d, N = 4, 16, 8, 32
    with fake_device_mesh(make_production_mesh(shape=(4, 2))) as dm:
        buf = _sharded(dm, (E, C, d), (None, None, None))
        rows = _sharded(dm, (N, d), ("data", None))
        e = _sharded(dm, (N,), ("data",), torch.int64)
        c = _sharded(dm, (N,), ("data",), torch.int64)
        with D.LocalCost() as cost:
            buf.index_put_((e, c), rows, accumulate=True)
        assert buf.to_local().shape == (E, C, d)
    coll = D.R.collective_bytes(cost.collectives)
    assert coll["counts"] == {"all-reduce": 1, "all-gather": 0,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 0}
    assert coll["bytes"]["all-reduce"] == E * C * d * 4
    assert cost.handled == {
        "aten.index_put_.default: rows added shard by shard": 1}


@pytest.mark.parametrize("spec,size,placed,gathered", [
    ((None, "model"), (8, 3, 2), ("R", "R"), 8 * 6 * 4),
    (("data", "model"), (1, 8, 3, 2), (1, "R"), 2 * 6 * 4)])
def test_a_refused_view_gathers_the_split_dim_once(spec, size, placed,
                                                   gathered):
    """Splitting a dim sharded over "model" into (3, 2) leaves 3 rows
    for 2 shards, which DTensor refuses: the dim is replicated over
    "model" alone (one all-gather, counted), a batch dim split over
    "data" stays split, and the view runs; the placements tried first
    and refused count nothing."""
    from torch.distributed.tensor import Replicate, Shard

    with fake_device_mesh(make_production_mesh(shape=(4, 2))) as dm:
        x = _sharded(dm, (8, 6), spec)
        with D.LocalCost() as cost:
            y = x.view(*size)
        assert y.placements == tuple(Replicate() if p == "R" else Shard(p)
                                     for p in placed)
    coll = D.R.collective_bytes(cost.collectives)
    assert coll["counts"]["all-gather"] == 1
    assert coll["total_bytes"] == gathered
    assert cost.handled == {"aten.view.default: replicated over model": 1}


@pytest.mark.parametrize("shape,size,touched,firsts", [
    ((128, 1, 25, 64), (128, 1, 1600), {2, 3}, {2}),
    ((128, 1, 1536), (128, 1, 4, 384), {2}, {2}),
    ((2, 3), (-1,), {0, 1}, {0}),
    ((8, 6), (8, 6), set(), set())])
def test_view_touched_groups_the_dims_a_view_merges_or_splits(
        shape, size, touched, firsts):
    assert D._view_touched(shape, size, int(np.prod(shape))) == (touched,
                                                                firsts)


def test_live_bytes_follow_each_storage_until_it_is_freed():
    """A view keeps its storage live after the tensor it came from is
    gone; the step's arguments are left out."""
    arg = torch.ones(10)
    with D.LocalCost() as cost:
        cost.exclude(arg)
        a = torch.ones(1000)
        b = a[1:]
        _ = arg.view(2, 5)
        del a
        assert cost.live == 4000
        del b
        assert cost.live == 0
        c = torch.ones(10)
    assert cost.peak == 4000 and cost.live == 40
    del c


def test_trace_compat_helpers_on_this_torch():
    """The torch internals the trace rests on, on the running version
    (torch 2.11 and 2.13 both)."""
    C.check_version()
    assert C.torch_version() >= C.MIN_VERSION
    t = torch.empty(6, device="meta")
    assert C.storage_of(t) is C.storage_of(t[2:])
    with C.fake_tensor_mode():
        f = torch.empty(3)
    assert C.is_fake(f) and not C.is_fake(t)
    assert C.fake_store() is not None
    assert issubclass(D.LocalCost, C.TorchDispatchMode)


def test_fake_device_mesh_refuses_a_second_group():
    mesh = make_production_mesh(shape=(2, 2))
    with fake_device_mesh(mesh) as dm:
        assert dm.mesh_dim_names == ("data", "model")
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already exists"):
            with fake_device_mesh(mesh):
                pass
    assert not dist.is_initialized()


def test_run_one_records_a_failure(monkeypatch):
    bad = dataclasses.replace(reduced("smollm-360m"), num_kv_heads=3)
    monkeypatch.setattr(D, "get_config", lambda arch: bad)
    rec = D.run_one("smollm-360m", "train_4k", mesh_shape=(2, 2),
                    verbose=False)
    assert not rec["ok"]
    assert rec["error"] and rec["traceback"]
    assert not dist.is_initialized()


def test_cli_writes_the_artifact_of_the_full_config(cli_run):
    """The port's counterpart of the reference's failing small-mesh test:
    the full SmolLM-360M config's train_4k on a 4x2 mesh."""
    proc, out = cli_run
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
    art = json.load(open(out / "smollm-360m__train_4k__4x2.json"))
    assert art["ok"] and art["chips"] == 8
    assert art["roofline"]["flops"] > 0
    assert art["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert "1/1 combos traced OK" in stdout
