"""Port parity for the dry-run's pure parts: ``launch.inputs`` (shape
configs, input specs, model flops, the step builders), the sharding
rules of ``sharding.specs``, ``launch.mesh.make_production_mesh``,
``launch.roofline.derive_terms`` and ``fl.profiles_from_partition``,
against the JAX package's.

Tolerances. Configs, shapes, dtypes, specs, flops counts and profiles
are compared exactly. The step builders run reduced SmolLM-360M,
Qwen1.5-MoE and Whisper in f32 on the reference's parameters: the first
train step's loss within rtol 1e-4 (tests/test_torch_train.py's), the
prefill and decode logits within rtol 1e-5 / atol 2e-5
(tests/test_torch_families.py's ``LOGIT_TOL``), and the greedy tokens
equal (tests/test_torch_serve.py's rule).

The reference's ``param_spec`` reads only a mesh's ``axis_names`` and
``devices.shape``, so a stand-in mesh holds it on the production shapes
here. Its other rules build ``NamedSharding`` on a real JAX mesh: they
run in a subprocess with 8 forced host devices, as
tests/test_dryrun_small.py runs the reference's dry-run.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget
from repro.fl import profiles_from_partition as ref_profiles
from repro.launch import inputs as JI
from repro.launch import roofline as JR
from repro.models import transformer as JT
from repro.sharding import specs as JS
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.fl import profiles_from_partition
from repro_torch.fl.partition import partition_labels
from repro_torch.launch import inputs as I
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as S

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = dict(rtol=1e-5, atol=2e-5)
SHAPES = list(I.SHAPES)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _port_leaves(tree) -> dict:
    out = {}
    S.tree_map_with_path(lambda p, x: out.__setitem__(
        "/".join(p), (tuple(x.shape), _dtype_name(x.dtype))), tree)
    return out


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_key(k) for k in path): (tuple(x.shape),
                                               _dtype_name(x.dtype))
            for path, x in flat}


def _cfg_fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("use_kernels", None)
    d.pop("use_pallas", None)
    return d


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def test_shapes_table_equals_reference():
    assert I.SHAPES == JI.SHAPES
    assert I.LONG_WINDOW == JI.LONG_WINDOW


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_config_specs_and_flops_equal_reference(arch):
    """For every shape: the adjusted config's fields, every input spec's
    shape and dtype (the decode cache's too) and the model flops."""
    for shape in SHAPES:
        cfg = I.shape_config(get_config(arch), shape)
        jcfg = JI.shape_config(jget(arch), shape)
        assert _cfg_fields(cfg) == _cfg_fields(jcfg), shape
        assert I.model_flops_for(cfg, shape) == JI.model_flops_for(jcfg,
                                                                   shape)
        specs = I.input_specs(cfg, shape)
        jspecs = JI.input_specs(jcfg, shape)
        assert set(specs) == set(jspecs)
        for part in specs:
            got = _port_leaves(specs[part])
            assert all(x.device.type == "meta"
                       for x in _leaves(specs[part]))
            assert got == _ref_leaves(jspecs[part]), (shape, part)


def _leaves(tree):
    out = []
    S.tree_map_with_path(lambda p, x: out.append(x), tree)
    return out


def test_shape_config_without_remat():
    cfg = I.shape_config(get_config("smollm-360m"), "train_4k", remat=False)
    jcfg = JI.shape_config(jget("smollm-360m"), "train_4k", remat=False)
    assert not cfg.remat
    assert _cfg_fields(cfg) == _cfg_fields(jcfg)
    assert I.shape_config(get_config("smollm-360m"), "train_4k").remat


# ---------------------------------------------------------------------------
# Step builders on reduced configs, from the reference's parameters
# ---------------------------------------------------------------------------

STEP_ARCHS = ["smollm-360m", "qwen2-moe-a2.7b", "whisper-large-v3"]
B, SEQ = 4, 16


@pytest.fixture(scope="module", params=STEP_ARCHS)
def step_case(request):
    name = request.param
    cfg, jcfg = get_config(name).reduced(), jget(name).reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(B, SEQ + 1)).astype(
        np.int32)
    extras = {}
    if cfg.is_enc_dec:
        extras["frames"] = rng.normal(size=(B, cfg.frontend_seq,
                                            cfg.frontend_dim)).astype(
            np.float32)
    return cfg, jcfg, params, jparams, toks, extras


def test_train_step_first_loss_matches_reference(step_case):
    cfg, jcfg, params, jparams, toks, extras = step_case
    w = np.full((B,), 1.0 / B, np.float32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "weights": w,
             **extras}
    step, opt = I.make_train_step(cfg, lr=1e-3)
    _, _, m = step(params, opt.init(params),
                   {k: torch.as_tensor(v) for k, v in batch.items()})
    # the reference step's first loss is its loss_fn at these params
    _, jm = jax.jit(lambda p, b: JT.loss_fn(jcfg, p, b))(
        jparams, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)


def test_prefill_and_serve_steps_match_reference(step_case):
    cfg, jcfg, params, jparams, toks, extras = step_case
    prompts = toks[:, :SEQ]
    tx = {k: torch.as_tensor(v) for k, v in extras.items()}
    jx = {k: jax.numpy.asarray(v) for k, v in extras.items()}
    logits, cache = I.make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(prompts), **tx})
    jlogits, jcache = JI.make_prefill_step(jcfg)(
        jparams, {"tokens": jax.numpy.asarray(prompts), **jx})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    memory = T.prefill(cfg, params, torch.as_tensor(prompts), tx)[2]
    jmemory = JT.prefill(jcfg, jparams, jax.numpy.asarray(prompts), jx)[2]
    cache = T.grow_cache(cfg, cache, 2)
    jcache = JT.grow_cache(jcfg, jcache, 2)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    jtok = np.asarray(jlogits[:, -1].argmax(-1))[:, None].astype(np.int32)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    batch = {"tokens": tok, "index": torch.tensor(SEQ, dtype=torch.int32)}
    jbatch = {"tokens": jax.numpy.asarray(jtok),
              "index": jax.numpy.asarray(SEQ, jax.numpy.int32)}
    if cfg.is_enc_dec:
        batch["memory"], jbatch["memory"] = memory, jmemory
    logits, _ = I.make_serve_step(cfg)(params, batch, cache)
    jlogits, _ = JI.make_serve_step(jcfg)(jparams, jbatch, jcache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits.argmax(-1)))


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

MESH_SHAPES = {"16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
               "4x2": ((4, 2), ("data", "model"))}


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _entries(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def _fake_params(cfg):
    with FakeTensorMode():
        return T.init_params(cfg, torch.Generator())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_equals_reference_on_every_leaf(ref_rules, arch):
    """Every leaf of the full config's parameters, on the 16x16, 2x16x16
    and 4x2 meshes, with and without ``expert_2d``."""
    params = _fake_params(get_config(arch))
    want_leaves = {k: (tuple(v[0]), v[1])
                   for k, v in ref_rules()[f"params/{arch}"].items()}
    assert _port_leaves(params) == want_leaves
    for name, (shape, axes) in MESH_SHAPES.items():
        mesh = make_production_mesh(multi_pod=len(shape) == 3,
                                    shape=shape[-2:])
        assert mesh.devices.shape == shape and mesh.axis_names == axes
        for expert_2d in (False, True):
            want = ref_rules()[f"param_spec/{name}/{expert_2d}/{arch}"]
            got = {}
            S.tree_map_with_path(lambda p, x: got.__setitem__(
                "/".join(p), _entries(S.param_spec(p, tuple(x.shape), mesh,
                                                   expert_2d=expert_2d))),
                params)
            assert got == want, (name, expert_2d)
            tree = S.params_shardings(params, mesh, expert_2d=expert_2d)
            assert {k: _entries(v) for k, v in _port_flat(tree).items()} \
                == want


def _port_flat(tree) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, S.PartitionSpec):
            out["/".join(path)] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
    walk(tree, ())
    return out


_REF_RULES = r"""
import json, os, sys, types
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from repro.configs import ARCH_IDS, get_config
from repro.launch import inputs as JI
from repro.models import transformer as JT
from repro.sharding import specs as JS

def key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))

def entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {"/".join(key(k) for k in p): entries(s.spec) for p, s in leaves}

stand_ins = {name: types.SimpleNamespace(axis_names=axes,
                                         devices=np.empty(shape))
             for name, shape, axes in %s}
meshes = [("4x2", jax.make_mesh((4, 2), ("data", "model"))),
          ("2x2x2", jax.make_mesh((2, 2, 2), ("pod", "data", "model")))]
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    params = jax.eval_shape(lambda: JT.init_params(
        cfg, jax.random.PRNGKey(0)))
    pflat = jax.tree_util.tree_flatten_with_path(params)[0]
    out["params/" + arch] = {"/".join(key(k) for k in p):
                             [list(x.shape), str(x.dtype)] for p, x in pflat}
    for name, stand_in in stand_ins.items():
        for e2d in (False, True):
            out[f"param_spec/{name}/{e2d}/{arch}"] = {
                "/".join(key(k) for k in p): entries(JS.param_spec(
                    p, x.shape, stand_in, expert_2d=e2d)) for p, x in pflat}
    for mname, mesh in meshes:
        rec = {"opt": flat(JS.opt_state_shardings(params, mesh))}
        for shp in JI.SHAPES:
            scfg = JI.shape_config(cfg, shp)
            specs = JI.input_specs(scfg, shp)
            rec["batch/" + shp] = flat(JS.batch_shardings(specs["batch"],
                                                          mesh))
            rec["replicated/" + shp] = flat(JS.replicated(specs["batch"],
                                                          mesh))
            if "cache" in specs:
                for som in (False, True):
                    rec[f"cache/{shp}/{som}"] = flat(JS.cache_shardings(
                        specs["cache"], mesh, batch=JI.SHAPES[shp][1],
                        seq_over_model=som))
        out[f"{mname}/{arch}"] = rec
json.dump(out, sys.stdout)
""" % repr([(n, s, a) for n, (s, a) in MESH_SHAPES.items()])


@pytest.fixture(scope="module", autouse=True)
def ref_rules():
    """The reference's rules, from a subprocess with 8 forced host
    devices, started with the module so that it runs beside the other
    tests; call to read them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_RULES],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT, env=env)
    got = {}

    def read():
        if not got:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-2000:]
            got.update(json.loads(stdout))
        return got
    yield read
    proc.kill()
    proc.communicate()


@pytest.mark.parametrize("mesh_name", ["4x2", "2x2x2"])
def test_opt_batch_cache_shardings_equal_reference(ref_rules, mesh_name):
    """``opt_state_shardings``, ``batch_shardings``, ``replicated`` and
    ``cache_shardings`` (both ways of ``seq_over_model``), every arch and
    shape, against the reference's on a real 8-device JAX mesh."""
    shape = (4, 2) if mesh_name == "4x2" else (2, 2, 2)
    mesh = make_production_mesh(multi_pod=len(shape) == 3,
                                shape=shape[-2:])
    flat = lambda tree: {k: _entries(v) for k, v in _port_flat(tree).items()}
    for arch in ARCH_IDS:
        want = ref_rules()[f"{mesh_name}/{arch}"]
        cfg = get_config(arch)
        got = {"opt": flat(S.opt_state_shardings(_fake_params(cfg), mesh))}
        for shp in I.SHAPES:
            specs = I.input_specs(I.shape_config(cfg, shp), shp)
            got["batch/" + shp] = flat(S.batch_shardings(specs["batch"],
                                                         mesh))
            got["replicated/" + shp] = flat(S.replicated(specs["batch"],
                                                         mesh))
            if "cache" in specs:
                for som in (False, True):
                    got[f"cache/{shp}/{som}"] = flat(S.cache_shardings(
                        specs["cache"], mesh, batch=I.SHAPES[shp][1],
                        seq_over_model=som))
        assert got.keys() == want.keys(), arch
        for k in want:
            assert got[k] == want[k], (arch, k)


def test_placements_split_a_dim_over_pod_and_data_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard

    def mesh(*sizes):
        return types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                     size=lambda i: sizes[i])
    m = mesh(2, 4, 2)
    assert S.placements(S.P(("pod", "data"), None, "model"), m) == [
        Shard(0), Shard(0), Shard(2)]
    assert S.placements(S.P(None, "data"), m) == [
        Replicate(), Shard(1), Replicate()]
    assert S.placements(S.P(), m) == [Replicate()] * 3
    # a split one way is none
    assert S.placements(S.P(("pod", "data"), None, "model"),
                        mesh(2, 4, 1)) == [Shard(0), Shard(0), Replicate()]


def test_placements_on_a_merged_pod_and_data_dim():
    """The trace's mesh with pod and data one dim: a spec over both is
    one split there; one that names only one of them, or an axis the
    mesh lacks, raises."""
    from torch.distributed.tensor import Replicate, Shard

    m = types.SimpleNamespace(mesh_dim_names=("pod+data", "model"),
                              size=lambda i: (8, 2)[i])
    assert S.placements(S.P(("pod", "data"), None, "model"), m) == [
        Shard(0), Shard(2)]
    assert S.placements(S.P(None, "model"), m) == [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="rest of mesh dim"):
        S.placements(S.P(None, "data"), m)
    with pytest.raises(ValueError, match="not axes"):
        S.placements(S.P("expert"), m)


def test_production_mesh_shapes_and_devices():
    m = make_production_mesh()
    assert m.devices.shape == (16, 16) and m.axis_names == ("data", "model")
    m = make_production_mesh(multi_pod=True)
    assert m.devices.shape == (2, 16, 16)
    assert m.axis_names == ("pod", "data", "model")
    assert {d.type for d in m.devices.reshape(-1)} == {"meta"}
    assert make_production_mesh(shape=(4, 2)).devices.shape == (4, 2)


# ---------------------------------------------------------------------------
# Roofline arithmetic
# ---------------------------------------------------------------------------

def test_derive_terms_equals_reference_with_the_same_constants(monkeypatch):
    monkeypatch.setattr(JR, "PEAK_FLOPS", R.PEAK_FLOPS)
    monkeypatch.setattr(JR, "HBM_BW", R.HBM_BW)
    monkeypatch.setattr(JR, "ICI_BW", R.LINK_BW)
    assert R.COLLECTIVE_KINDS == JR.COLLECTIVE_KINDS
    for cost, coll, chips, mf in [
            ({"flops": 989e12, "bytes accessed": 3.35e12},
             {"total_bytes": 25e9}, 4, 4 * 989e12),
            ({"flops": 1.5e12, "bytes accessed": 9e12},
             {"total_bytes": 1e9}, 256, 7e14),
            ({"flops": 0.0}, {"total_bytes": 5e11}, 8, 1.0),
            ({}, {"total_bytes": 0}, 1, 0.0)]:
        got = R.derive_terms(cost, coll, chips, mf).as_dict()
        want = JR.derive_terms(cost, coll, chips, mf).as_dict()
        assert got == want
    t = R.derive_terms({"flops": R.PEAK_FLOPS, "bytes accessed": R.HBM_BW},
                       {"total_bytes": R.LINK_BW / 2}, 1, R.PEAK_FLOPS)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(0.5)


def test_collective_bytes_maps_every_kind_and_refuses_unknown_ops():
    recs = [("all_gather_into_tensor", 100), ("all_reduce", 8),
            ("reduce_scatter_tensor", 4), ("all_to_all_single", 2),
            ("wait_tensor", 100), ("all_gather_into_tensor", 1)]
    out = R.collective_bytes(recs)
    assert out["bytes"] == {"all-reduce": 8, "all-gather": 101,
                            "reduce-scatter": 4, "all-to-all": 2,
                            "collective-permute": 0}
    assert out["counts"]["all-gather"] == 2
    assert out["total_bytes"] == 115
    with pytest.raises(ValueError, match="no collective kind"):
        R.collective_bytes([("send_recv", 4)])


# ---------------------------------------------------------------------------
# profiles_from_partition
# ---------------------------------------------------------------------------

def test_profiles_from_partition_equals_reference():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 10, size=2_000)
    parts = partition_labels(labels, 24, "type2", 10, seed=1)
    got = profiles_from_partition(labels, parts, 10, seed=5)
    want = ref_profiles(labels, parts, 10, seed=5)
    assert len(got) == len(want) == 24
    for a, b in zip(got, want):
        assert a.client_id == b.client_id and a.cost == b.cost
        assert a.available == b.available
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.histogram, b.histogram)


def test_dry_run_modules_import_neither_jax_nor_the_reference():
    blocker = (
        "import sys\n"
        "class B:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'repro'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.inputs\n"
        "import repro_torch.launch.roofline, repro_torch.launch.mesh\n"
        "import repro_torch.sharding, repro_torch.fl\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", blocker], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
