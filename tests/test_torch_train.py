"""Port parity for the FedSGD trainer: ``fl.round.make_fedsgd_step``
against the JAX package's on reduced SmolLM-360M, Qwen1.5-MoE (its
router's aux loss in the total) and Whisper-large-v3 (the ``frames``
extra), from the reference's initial parameters, and the training
entry point ``launch.train.main`` against the reference's.

Tolerances (f32 throughout; reduced configs are f32):

- the first step's loss and every gradient leaf: rtol 1e-4 / atol 1e-6.
  The two frameworks sum the same products in other orders.
- three Adam steps (``adam(warmup_cosine(3e-3, 10, 3), grad_clip=1.0)``):
  losses within rtol 1e-4. Adam divides each gradient by its own running
  scale, so an entry whose gradient is near 0 moves by about the full
  learning rate on either side whatever its rounding: later parameters
  are not held entry by entry, the losses they give are.
- ``microbatches=2``: each microbatch's gradient is cast to f32 and
  scaled by its weight share, then summed: the same rtol 1e-4 / atol
  1e-6 against the full batch (dense models; an MoE layer's expert
  capacity depends on the tokens a call routes, so its microbatches drop
  other tokens than the full batch, in both packages alike) and against
  the reference's scanned and unrolled accumulation.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.fl.round import make_fedsgd_step as ref_fedsgd
from repro.launch import train as ref_train
from repro.models import transformer as jT
from repro.optim import adam as ref_adam
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_lm_data
from repro_torch.fl.partition import client_histograms, partition_labels
from repro_torch.fl.round import make_fedsgd_step
from repro_torch.launch import train
from repro_torch.models import transformer as T

ARCHS = ["smollm-360m", "qwen2-moe-a2.7b", "whisper-large-v3"]
B, SEQ = 8, 16
SUBSETS = [[0, 1, 2, 3], [4, 5, 6, 7], [1, 3, 5, 7]]


def _grad_catcher_jax():
    """An optimizer whose state becomes the gradients it is handed."""
    return types.SimpleNamespace(
        init=lambda p: {},
        update=lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like,
                                                            g), g))


def _grad_catcher():
    return types.SimpleNamespace(
        init=lambda p: {},
        update=lambda g, s, p=None: (optim.tree_map(torch.zeros_like, g), g))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch, port config, reference config, reference params as numpy,
    three batches as numpy dicts)."""
    name = request.param
    cfg = get_config(name).reduced()
    jcfg = ref_config(name).reduced()
    jparams = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(0)))
    data = make_lm_data(8 * 64, SEQ, cfg.vocab_size, seed=0)
    parts = partition_labels(data.labels, 8, "type2", data.num_classes,
                             seed=0)
    hists = client_histograms(data.labels, parts, data.num_classes)
    rng = np.random.default_rng(0)
    # subsets of 4: two sequences a client, so a batch splits in two
    batches = [{k: v.numpy() for k, v in train.client_batch(
        cfg, data, parts, hists, subset, B, rng, "cpu").items()}
        for subset in SUBSETS]
    return name, cfg, jcfg, jparams, batches


def _port_step(cfg, optimizer, **kw):
    return make_fedsgd_step(lambda p, b: T.loss_fn(cfg, p, b), optimizer,
                            **kw)


def _ref_step(jcfg, optimizer, **kw):
    return jax.jit(ref_fedsgd(lambda p, b: jT.loss_fn(jcfg, p, b),
                              optimizer, **kw))


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _assert_trees_close(port, ref, rtol=1e-4, atol=1e-6):
    ref_leaves = jax.tree_util.tree_leaves(ref)
    port_leaves = optim.tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    for i, (a, b) in enumerate(zip(port_leaves, ref_leaves)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol, err_msg=f"leaf {i}")


def _first_step(cfg, params, batch, **kw):
    _, grads, metrics = _port_step(cfg, _grad_catcher(), **kw)(
        params, {}, _torch_batch(batch))
    return grads, metrics


def _ref_first_step(jcfg, jparams, batch, **kw):
    _, grads, metrics = _ref_step(jcfg, _grad_catcher_jax(), **kw)(
        jparams, {}, _jax_batch(batch))
    return grads, metrics


def test_first_step_loss_and_gradients_match(arch):
    name, cfg, jcfg, jparams, batches = arch
    grads, metrics = _first_step(cfg, T.params_from_jax(jparams), batches[0])
    jgrads, jmetrics = _ref_first_step(jcfg, jparams, batches[0])
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    if name.startswith("qwen"):
        assert float(metrics["aux_loss"]) > 0    # the router's loss counts
    _assert_trees_close(grads, jgrads)


def test_three_adam_steps_match(arch):
    name, cfg, jcfg, jparams, batches = arch
    step = _port_step(cfg, optim.adam(optim.warmup_cosine(3e-3, 10, 3),
                                      grad_clip=1.0))
    jopt = ref_adam(ref_warmup_cosine(3e-3, 10, 3), grad_clip=1.0)
    jstep = _ref_step(jcfg, jopt)
    params = T.params_from_jax(jparams)
    state = optim.adam(1.0).init(params)
    jp, jstate = jparams, jopt.init(jparams)
    losses, jlosses = [], []
    for b in batches:
        params, state, m = step(params, state, _torch_batch(b))
        jp, jstate, jm = jstep(jp, jstate, _jax_batch(b))
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert int(state["count"]) == 3


@pytest.mark.parametrize("unroll", [False, True])
def test_microbatches_accumulate_as_reference(arch, unroll):
    name, cfg, jcfg, jparams, batches = arch
    params = T.params_from_jax(jparams)
    grads2, m2 = _first_step(cfg, params, batches[0], microbatches=2,
                             unroll_microbatches=unroll)
    jgrads2, jm2 = _ref_first_step(jcfg, jparams, batches[0],
                                   microbatches=2,
                                   unroll_microbatches=unroll)
    assert all(g.dtype == torch.float32 for g in optim.tree_leaves(grads2))
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               rtol=1e-4)
    _assert_trees_close(grads2, jgrads2)
    other, _ = _first_step(cfg, params, batches[0], microbatches=2,
                           unroll_microbatches=not unroll)
    for a, b in zip(optim.tree_leaves(grads2), optim.tree_leaves(other)):
        assert torch.equal(a, b)              # one loop either way
    if cfg.is_moe:
        return
    grads1, m1 = _first_step(cfg, params, batches[0])
    np.testing.assert_allclose(float(m2["loss"]),
                               float(m1["loss"] + m1["aux_loss"]), rtol=1e-4)
    for a, b in zip(optim.tree_leaves(grads2), optim.tree_leaves(grads1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_make_extras_match_reference():
    for name in ARCHS + ["internvl2-26b"]:
        cfg, jcfg = get_config(name).reduced(), ref_config(name).reduced()
        got = train.make_extras(cfg, 3, np.random.default_rng(5), "cpu")
        want = ref_train.make_extras(jcfg, 3, np.random.default_rng(5))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_main_matches_reference(monkeypatch):
    """``main`` at reduced settings on the CPU with the reference's
    initial parameters swapped in: the same client batches step by step
    (composition, weights), the same printed summary, losses within rtol
    1e-4 (three Adam steps, as above)."""
    argv = ["--steps", "3", "--clients", "8", "--seq", "16"]
    jcfg = ref_config("smollm-360m").reduced()
    jparams = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(0)))
    seen = {"reference": [], "port": []}

    def recorded(step, key):
        def run(params, opt_state, batch):
            seen[key].append({k: np.asarray(v) for k, v in batch.items()})
            return step(params, opt_state, batch)
        return run

    # the reference jits its step: record around the jitted function
    monkeypatch.setattr(ref_train, "jax", types.SimpleNamespace(
        jit=lambda f: recorded(jax.jit(f), "reference"),
        random=jax.random, tree_util=jax.tree_util))
    make = train.make_fedsgd_step
    monkeypatch.setattr(train, "make_fedsgd_step",
                        lambda *a, **kw: recorded(make(*a, **kw), "port"))
    monkeypatch.setattr(train.T, "init_params",
                        lambda cfg, gen: T.params_from_jax(jparams))
    want = ref_train.main(argv)
    got = train.main(argv + ["--device", "cpu"])
    assert len(seen["port"]) == len(seen["reference"]) == 3
    for a, b in zip(seen["port"], seen["reference"]):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])
