"""Port parity: one chunk of the device round plane
(``make_fl_rounds_scan``: S=3 rounds, K=4 slots with padding, dropout
on) against the JAX package's, from the same parameters, dataset,
schedule and seed.

Masks come from bit-exact counter-based draws and must be equal.
Params, q-values and losses come from f32 training whose convolution
and reduction orders differ between the frameworks: they are held to
rtol 1e-4 / atol 1e-5 (params, losses) and atol 1e-4 (q, a cosine in
[-1, 1]) after 3 rounds x 2 local steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_classification_data as ref_make_data
from repro.fl import device_data as ref_dd
from repro.fl.partition import partition_labels as ref_partition
from repro.fl.round import flatten_stacked as ref_flatten
from repro.fl.round import make_fl_rounds_scan as ref_scan
from repro.models import cnn as jcnn
from repro_torch import optim
from repro_torch import random as trandom
from repro_torch.data.synthetic import make_classification_data
from repro_torch.fl import device_data
from repro_torch.fl.partition import partition_labels
from repro_torch.fl.round import flatten_stacked, make_fl_rounds_scan
from repro_torch.kernels import ops as kops
from repro_torch.models import cnn

SEED = 4


def test_data_and_partition_identical():
    a = ref_make_data("mnist", 300, seed=SEED)
    b = make_classification_data("mnist", 300, seed=SEED)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    pa = ref_partition(a.labels, 8, "type2", 10, seed=SEED)
    pb = partition_labels(b.labels, 8, "type2", 10, seed=SEED)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)


def test_flatten_order_matches_jax_tree_order():
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: rng.standard_normal((3,) + x.shape).astype(np.float32),
        jcnn.init_params(jcnn.MNIST_CNN, jax.random.PRNGKey(0)))
    ref_flat, _ = ref_flatten(tree)
    flat, unflatten = flatten_stacked(
        {k: torch.as_tensor(v) for k, v in
         ((f"{l}.{x}", tree[l][x]) for l in tree for x in ("w", "b"))})
    np.testing.assert_array_equal(np.asarray(ref_flat), flat.numpy())
    back = unflatten(flat[1])
    np.testing.assert_array_equal(back["fc1.w"].numpy(), tree["fc1"]["w"][1])


@pytest.fixture(scope="module")
def chunk_results():
    data = make_classification_data("mnist", 300, seed=SEED)
    parts = partition_labels(data.labels, 8, "type2", 10, seed=SEED)
    parts[5] = parts[5][:0]                  # an empty client: inactive slot
    rows = np.array([[0, 3, 5, 0], [1, 2, 6, 7], [4, 0, 0, 0]], np.int64)
    active = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0]], np.float32)
    weights = active * np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    round_ids = np.array([5, 6, 7])
    kw = dict(local_lr=0.1, local_steps=2, batch_size=8, server_lr=1.0,
              dropout_rate=0.4)

    jparams = jcnn.init_params(jcnn.MNIST_CNN, jax.random.PRNGKey(SEED))
    jfn = ref_scan(lambda p, b: jcnn.loss_fn(jcnn.MNIST_CNN, p, b,
                                             impl="reference"), **kw)
    jsched = {"rows": jnp.asarray(rows, jnp.int32),
              "weights": jnp.asarray(weights), "active": jnp.asarray(active),
              "round_ids": jnp.asarray(round_ids, jnp.int32)}
    # copy first: the reference's chunk_fn donates its params
    params0 = cnn.params_from_jax(jax.tree_util.tree_map(np.array, jparams))
    jout, jinfo = jfn(jparams, ref_dd.DeviceDataset.stage(data, parts),
                      jsched, jax.random.PRNGKey(SEED))

    sched = {"rows": torch.as_tensor(rows), "weights": torch.as_tensor(weights),
             "active": torch.as_tensor(active),
             "round_ids": torch.as_tensor(round_ids)}
    dd = device_data.DeviceDataset.stage(data, parts, "cpu")
    loss = lambda p, b: cnn.loss_fn(cnn.MNIST_CNN, p, b)
    out, info = make_fl_rounds_scan(loss, **kw)(params0, dd, sched,
                                                trandom.prng_key(SEED))
    plain_out, plain_info = make_fl_rounds_scan(
        loss, kernels=kops.PLAIN, **kw)(params0, dd, sched,
                                        trandom.prng_key(SEED))
    return (jax.tree_util.tree_map(np.asarray, jout),
            jax.tree_util.tree_map(np.asarray, jinfo), out, info, active,
            plain_out, plain_info)


def test_masks_bit_identical(chunk_results):
    _, jinfo, _, info, active, _, _ = chunk_results
    np.testing.assert_array_equal(jinfo["masks"], info["masks"].numpy())
    masks = info["masks"].numpy()
    assert masks[0, 2] == 0.0                  # empty pool -> inactive
    assert (masks < active).any(), "dropout never fired; test is vacuous"


def test_params_q_losses_match(chunk_results):
    jout, jinfo, out, info, _, _, _ = chunk_results
    for layer in cnn.LAYERS:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(out[f"{layer}.{leaf}"].numpy(),
                                       jout[layer][leaf], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{layer}.{leaf}")
    np.testing.assert_allclose(info["q_values"].numpy(), jinfo["q_values"],
                               atol=1e-4)
    for key in ("client_losses", "mean_loss"):
        np.testing.assert_allclose(info[key].numpy(), jinfo[key],
                                   rtol=1e-4, atol=1e-5)


def test_aggregate_seam_takes_plain_version(chunk_results):
    """On the CPU the wrapper is the plain version, so a chunk run with
    ``kernels=ops.PLAIN`` agrees bit for bit; on the card the same seam
    holds kernel against plain."""
    _, _, out, info, _, plain_out, plain_info = chunk_results
    for k in out:
        assert torch.equal(out[k], plain_out[k])
    for k in info:
        assert torch.equal(info[k], plain_info[k])


def test_unported_options_raise():
    """Compression, server optimizers, the two-pass aggregate and
    fault-mode arrival masks are ported; the one option of the
    reference's chunk function still missing is the LM batch gather
    (``gather_fn``, ROADMAP.md Queue 1 item 7), which the signature
    refuses; a bad codec spec is refused when the chunk function is
    built."""
    loss = lambda p, b: cnn.loss_fn(cnn.MNIST_CNN, p, b)
    with pytest.raises(TypeError, match="gather_fn"):
        make_fl_rounds_scan(loss, gather_fn=lambda d, r, p: None)
    for kw in ({}, {"compression": "int8"}, {"fused_quality": False},
               {"compression": "topk:0.05+int8",
                "server_opt": optim.fedadam(0.01)}):
        assert callable(make_fl_rounds_scan(loss, **kw))
    with pytest.raises(ValueError, match="compression"):
        make_fl_rounds_scan(loss, compression="gzip")
