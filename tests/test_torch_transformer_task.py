"""The federated LoRA LM task of the port against the JAX package's, on
the CPU, at the reduced SmolLM-360M config (2 layers, d 128, f32).

Tolerances, and why:

- ``make_lm_data``, the staged dataset, the slot-keyed draws and
  ``gather_lm_batches``: exact (the same numpy generator; the port's
  threefry is bit-exact with ``jax.random``);
- ``merge_adapters`` from the same weights: rtol 1e-6 (one f32 einsum of
  rank 4 and one add, in either framework's order);
- one round of ``make_transformer_fl``'s defaults from the reference's
  backbone and adapters: the adapter update within 1e-4 of its largest
  entry and q_t within 1e-5 absolute (two local SGD steps at lr 5
  through an f32 transformer in two frameworks; seen: 1.3e-6 and
  6e-7);
- codec round-trips of real LoRA deltas: exact (the plain codecs equal
  the JAX package's Pallas kernels in interpret mode bit for bit,
  tests/test_torch_compression.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_syn
from repro.fl import compression as ref_comp
from repro.fl import device_data as ref_dd
from repro.fl import transformer_task as ref_tt
from repro_torch import random as trandom
from repro_torch.data import synthetic
from repro_torch.fl import compression as comp
from repro_torch.fl import device_data
from repro_torch.fl import transformer_task as tt
from repro_torch.fl.partition import partition_labels
from repro_torch.fl.round import _make_client_update, flatten_stacked
from repro_torch.models import transformer

SUBSETS = [[0, 3, 5, 7], [1, 2, 4, 6, 8]]
WEIGHTS = [np.full(4, 0.25, np.float32), np.full(5, 0.2, np.float32)]


def t2n(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("n,seq_len,vocab,seed", [
    (50, 8, 64, 0), (7, 1, 2, 3), (200, 33, 49152, 1)])
def test_make_lm_data_equals_reference(n, seq_len, vocab, seed):
    got = synthetic.make_lm_data(n, seq_len, vocab, seed=seed)
    want = ref_syn.make_lm_data(n, seq_len, vocab, seed=seed)
    assert got.tokens.dtype == want.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.num_classes, got.vocab_size) == (want.num_classes,
                                                 want.vocab_size)


@pytest.mark.parametrize("rnd,K,E,b", [(0, 4, 2, 4), (7, 6, 1, 3)])
def test_gather_lm_batches_equals_reference(rnd, K, E, b):
    data = synthetic.make_lm_data(120, 8, 64, seed=2)
    parts = partition_labels(data.labels, 10, "type2", data.num_classes,
                             seed=2)
    rows = np.array([1, 4, 0, 9, 3, 7][:K])
    ref_data = ref_dd.DeviceLMDataset.stage(data, parts)
    _, ref_pos = ref_dd.sample_positions(jax.random.PRNGKey(5), rnd, K, E, b)
    want = ref_dd.gather_lm_batches(ref_data, jnp.asarray(rows, jnp.int32),
                                    ref_pos)
    staged = device_data.DeviceLMDataset.stage(data, parts, "cpu")
    assert staged.n_clients == ref_data.n_clients == 10
    _, pos = device_data.sample_positions(trandom.prng_key(5), rnd, K, E, b)
    np.testing.assert_array_equal(t2n(pos), np.asarray(ref_pos))
    got = device_data.gather_lm_batches(staged, torch.as_tensor(rows), pos)
    for k in ("tokens", "targets"):
        assert got[k].shape == (K, E, b, 8)
        np.testing.assert_array_equal(t2n(got[k]), np.asarray(want[k]))


@pytest.fixture(scope="module")
def bundles():
    """The reference's defaults bundle and the port's, the port started
    from the reference's backbone and adapters."""
    ref = ref_tt.make_transformer_fl(n_clients=10, n_train=100, n_test=30,
                                     seq_len=8)
    port = tt.make_transformer_fl(n_clients=10, n_train=100, n_test=30,
                                  seq_len=8, device="cpu")
    rt, pt = ref["trainer"], port["trainer"]
    pt.base_params = transformer.params_from_jax(
        jax.tree_util.tree_map(np.asarray, rt.base_params))
    pt.params = {f"{p}/{ab}": torch.tensor(np.asarray(rt.params[p][ab]))
                 for p in rt.params for ab in ("a", "b")}
    return ref, port


def test_merge_adapters_equals_reference(bundles):
    ref, port = bundles
    rt, pt = ref["trainer"], port["trainer"]
    rng = np.random.default_rng(0)
    ref_ad = {p: {"a": np.asarray(rt.params[p]["a"]),
                  "b": rng.standard_normal(np.shape(rt.params[p]["b"]))
                  .astype(np.float32)} for p in rt.params}
    want = ref_tt.merge_adapters(rt.base_params, ref_ad, rt.lora)
    got = tt.merge_adapters(pt.base_params, {
        f"{p}/{ab}": torch.tensor(ref_ad[p][ab])
        for p in ref_ad for ab in ("a", "b")}, pt.lora)
    for block, leaf in (("attn", "wq"), ("attn", "wv"), ("mlp", "w_up"),
                        ("attn", "wk")):
        np.testing.assert_allclose(t2n(got["layers"][block][leaf]),
                                   np.asarray(want["layers"][block][leaf]),
                                   rtol=1e-6, atol=1e-7)
    assert sum(v.numel() for v in pt.params.values()) == sum(
        np.size(x) for x in jax.tree_util.tree_leaves(rt.params))


def test_one_round_equals_reference(bundles):
    ref, port = bundles
    rt, pt = ref["trainer"], port["trainer"]
    before = {k: v.clone() for k, v in pt.params.items()}
    ref_before = jax.tree_util.tree_map(np.asarray, rt.params)
    want = rt.run_rounds(0, SUBSETS, WEIGHTS)
    got = pt.run_rounds(0, SUBSETS, WEIGHTS)
    for (wm, wq, wmet), (gm, gq, gmet) in zip(want, got):
        np.testing.assert_array_equal(gm, np.asarray(wm))
        np.testing.assert_allclose(gq, np.asarray(wq), rtol=0, atol=1e-5)
        assert gmet["round"] == wmet["round"]
    for p in rt.params:
        for ab in ("a", "b"):
            dw = np.asarray(rt.params[p][ab]) - ref_before[p][ab]
            dp = t2n(pt.params[f"{p}/{ab}"] - before[f"{p}/{ab}"])
            scale = np.abs(dw).max()
            assert scale > 0
            np.testing.assert_allclose(dp, dw, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("spec", ["int8", "int8@chunk=128", "topk:0.05",
                                  "topk:0.05+int8"])
def test_codec_roundtrip_of_lora_deltas_equals_reference(bundles, spec):
    _, port = bundles
    pt = port["trainer"]
    K, E, b = 4, 2, 4
    _, pos = device_data.sample_positions(pt.base_key, 3, K, E, b)
    batch = device_data.gather_lm_batches(
        pt.data, torch.as_tensor([0, 2, 5, 9]), pos)
    update = torch.func.vmap(_make_client_update(pt._loss, 5.0),
                             in_dims=(None, 0))
    with torch.no_grad():
        deltas, _ = update(pt.params, batch)
    flat, _ = flatten_stacked(deltas)
    assert flat.shape == (K, sum(v.numel() for v in pt.params.values()))
    parsed = comp.CompressionSpec.parse(spec)
    got = comp.roundtrip(flat, parsed)
    want = ref_comp.roundtrip(jnp.asarray(t2n(flat)),
                              ref_comp.CompressionSpec.parse(spec),
                              interpret=True)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


def test_evaluate_equals_reference(bundles):
    """Next-token accuracy of the same adapters over the same 30 x 8
    test tokens: equal up to one token whose top two logits are within
    the frameworks' f32 difference."""
    ref, port = bundles
    rt, pt = ref["trainer"], port["trainer"]
    pt.params = {f"{p}/{ab}": torch.tensor(np.asarray(rt.params[p][ab]))
                 for p in rt.params for ab in ("a", "b")}
    a, b = pt.evaluate(), pt.evaluate()
    assert a == b and 0.0 <= a <= 1.0
    assert a == pytest.approx(rt.evaluate(), abs=1 / 240 + 1e-9)
