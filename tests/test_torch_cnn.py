"""Port parity: ``repro_torch.models.cnn`` against the JAX package's
``repro.models.cnn`` with ``impl="reference"``, on parameters carried
across with ``params_from_jax``.

Tolerances: both run f32 convolutions and matmuls with different
summation orders, so logits and losses agree to ~1e-6 relative; the
gradients chain two such convolutions backwards and are held to
rtol 1e-4, atol 1e-5 (max-pool ties do not matter: the inputs are
continuous random draws).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro_torch.models import cnn

CONFIGS = {"mnist": (jcnn.MNIST_CNN, cnn.MNIST_CNN),
           "cifar": (jcnn.CIFAR_CNN, cnn.CIFAR_CNN)}


def setup(name, B=6, seed=0):
    jcfg, cfg = CONFIGS[name]
    jparams = jcnn.init_params(jcfg, jax.random.PRNGKey(seed))
    params = cnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(seed)
    images = rng.random((B, cfg.height, cfg.width, cfg.channels),
                        dtype=np.float32)
    labels = rng.integers(0, cfg.num_classes, size=B)
    return jcfg, cfg, jparams, params, images, labels


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_and_shapes_match(name):
    jcfg, cfg, jparams, params, _, _ = setup(name)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    shapes = cnn.param_shapes(cfg)
    for layer in cnn.LAYERS:
        for leaf in ("w", "b"):
            assert tuple(jparams[layer][leaf].shape) == \
                shapes[f"{layer}.{leaf}"]
    gen = cnn.init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in gen.items()} == shapes


def test_cifar_cnn_parameter_count():
    n = sum(int(np.prod(s)) for s in cnn.param_shapes(cnn.CIFAR_CNN).values())
    assert n == 1_070_794


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_loss_match_reference(name):
    jcfg, cfg, jparams, params, images, labels = setup(name)
    ref = np.asarray(jcnn.forward(jcfg, jparams, jnp.asarray(images),
                                  impl="reference"))
    out = cnn.forward(cfg, params, torch.as_tensor(images)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    rl, rm = jcnn.loss_fn(jcfg, jparams, {"images": jnp.asarray(images),
                                          "labels": jnp.asarray(labels)},
                          impl="reference")
    pl, pm = cnn.loss_fn(cfg, params, {"images": torch.as_tensor(images),
                                       "labels": torch.as_tensor(labels)})
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-6)
    assert pm["accuracy"].item() == float(rm["accuracy"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_weighted_loss_matches_reference(name):
    jcfg, cfg, jparams, params, images, labels = setup(name, seed=3)
    w = np.random.default_rng(3).random(len(labels)).astype(np.float32)
    rl, _ = jcnn.loss_fn(jcfg, jparams, {"images": jnp.asarray(images),
                                         "labels": jnp.asarray(labels),
                                         "weights": jnp.asarray(w)})
    pl, _ = cnn.loss_fn(cfg, params, {"images": torch.as_tensor(images),
                                      "labels": torch.as_tensor(labels),
                                      "weights": torch.as_tensor(w)})
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gradients_match_reference(name):
    jcfg, cfg, jparams, params, images, labels = setup(name, seed=1)
    jg = jax.grad(lambda p: jcnn.loss_fn(
        jcfg, p, {"images": jnp.asarray(images),
                  "labels": jnp.asarray(labels)}, impl="reference")[0])(jparams)
    g = torch.func.grad(lambda p: cnn.loss_fn(
        cfg, p, {"images": torch.as_tensor(images),
                 "labels": torch.as_tensor(labels)})[0])(params)
    for layer in cnn.LAYERS:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(
                g[f"{layer}.{leaf}"].numpy(), np.asarray(jg[layer][leaf]),
                rtol=1e-4, atol=1e-5, err_msg=f"{layer}.{leaf}")


def test_flatten_order_is_hwc():
    """Scrambling fc1's rows from (H, W, C) to (C, H, W) order changes
    the logits: the parity above would catch an NCHW flatten."""
    _, cfg, _, params, images, _ = setup("mnist", seed=2)
    h, w, c = cfg.height // 4, cfg.width // 4, cfg.conv2
    perm = torch.arange(h * w * c).reshape(h, w, c).permute(2, 0, 1).reshape(-1)
    scrambled = dict(params, **{"fc1.w": params["fc1.w"][perm]})
    x = torch.as_tensor(images)
    assert not torch.allclose(cnn.forward(cfg, params, x),
                              cnn.forward(cfg, scrambled, x), atol=1e-3)


def test_module_matches_functional_and_roundtrip():
    jcfg, cfg, jparams, params, images, _ = setup("cifar")
    model = cnn.CNN(cfg, params)
    x = torch.as_tensor(images)
    with torch.no_grad():
        assert torch.equal(model(x), cnn.forward(cfg, params, x))
    assert sorted(dict(model.named_parameters())) == sorted(params)
    back = cnn.params_to_jax(params)
    for layer in cnn.LAYERS:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(back[layer][leaf],
                                          np.asarray(jparams[layer][leaf]))


def test_params_from_jax_checks_names_and_shapes():
    tree = jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.MNIST_CNN, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError):
        cnn.params_from_jax({k: v for k, v in tree.items() if k != "fc2"})
    bad = dict(tree, fc1={"w": tree["fc1"]["w"], "b": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        cnn.params_from_jax(bad)
