"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without CUDA; the
file imports no JAX, so it runs on a machine that has only PyTorch:
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: the kernel sums in f32 in another order than the plain
version (per-thread, then per-block partials), so f32 outputs agree to
rtol 1e-5 with an absolute floor scaled by the sum's size; bf16 agg
may differ by one bf16 ulp where the f32 sums straddle a rounding
boundary. ``segmented_topk`` and ``mkp_utility`` are held to their
plain versions exactly: the top-k is a selection (values and lanes of
every finite entry equal), and the utility kernel rounds every product,
sum and division as the plain version does. So are the codec kernels
``topk_sparsify`` (values and indices), ``quantize_i8`` (values and
scales; one correctly rounded f32 operation a step) and
``dequantize_i8``; ``fedavg_agg_quality_i8`` is held as
``fedavg_agg_quality`` in f32. ``fedavg_agg`` sums each column's K
terms in one fixed order with fmaf, the plain version through a matmul:
f32 within rtol 1e-5 / atol 1e-5 (K up to 3,000), bf16 within one bf16
ulp; ``fedavg_agg_tree`` runs the same per-column loop over every leaf
in one launch, so each leaf is ``torch.equal`` to its own launch. A
compressed round chunk through the
kernels against the same chunk through ``kernels.ops.PLAIN``: masks and
bytes exact; the first round's payloads are equal and only the f32 sums
of the aggregate differ, so a later round may move an int8 value by a
step or swap a near-tie at the top-k threshold: at most 0.1 % of the
parameters beyond rtol 1e-4 / atol 1e-5, none beyond half the chunk's
largest parameter change.

The serve path's kernels. ``rmsnorm``: f32 within rtol = atol = 2e-5
(sum-of-squares order and ``rsqrtf``); bf16 within two bf16 ulps (rtol
2**-6), as an ulp of difference before the cast can become two after the
scale's rounding. ``swiglu``: both sides sum exact products in f32 in
another order, and the kernel's SiLU is g / (1 + exp(-g)) where the plain
version's is g * sigmoid(g): rtol 1e-5 in f32 and one bf16 ulp (2**-7) in
bf16, with atol 1e-4 in both, since where g is near 0 its f32 sum of D
products loses its relative accuracy and |u| (up to about 30) scales
that error (seen: 3e-5 at D = 960 in bf16); every route that takes the
operands (``wgmma``, ``splitk``, ``mma.sync``) is held the same way.
``flash_attention``: f32
rtol = atol = 2e-5, bf16 2e-2 (the reference's own kernel tolerances,
tests/test_kernels.py; the bf16 kernel also rounds the probabilities to
bf16 for the P·V product). ``mlstm_scan``: kernel and plain version
compute in f32 (bf16 inputs converted exactly) and sum in other orders,
over up to 256 keys a chunk and 384 head dims: the output and the f32
state within rtol 1e-4 and an atol of 2e-5 x max(1, the largest |value|)
(seen: 1.1e-5 relative at dk = dv = 384; the floor holds a state that is
0 on one side, as the SSD form's m, to f32 rounding of unit-scale
gates); a bf16 output, rounded once from f32 on both sides, within one
bf16 ulp (rtol 2**-7) and the same atol. The chunked route (bf16) takes
each f32 operand of a product as three exact bf16 terms on the tensor
cores, summed in f32, so it is held to the same tolerances.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch import random as trandom
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.core.pool import ClientPoolState
from repro_torch.data.synthetic import make_classification_data
from repro_torch.fl import device_data
from repro_torch.fl.compression import CompressionSpec, bytes_per_client
from repro_torch.fl.partition import partition_labels
from repro_torch.fl.round import make_fl_round, make_fl_rounds_scan
from repro_torch.kernels import build
from repro_torch.kernels import compression as kcomp
from repro_torch.kernels import fedavg_agg, mkp_utility, ops, ref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mlstm_scan as kmlstm
from repro_torch.kernels import rmsnorm as krms
from repro_torch.kernels import segmented_topk
from repro_torch.kernels import swiglu as kswiglu
from repro_torch.kernels import tma
from repro_torch.models import cnn
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 3, 13, 64])
@pytest.mark.parametrize("P", [1, 255, 4097, 1_070_794])
def test_kernel_matches_plain(cuda, K, P, dtype):
    g = torch.Generator(device=cuda).manual_seed(K * 7919 + P)
    u = torch.randn(K, P, generator=g, device=cuda).to(dtype)
    w = torch.rand(K, generator=g, device=cuda)
    w = w / w.sum()
    before = ops.LAUNCHES["fedavg_agg_quality"]
    out = ops.fedavg_agg_quality(u, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedavg_agg_quality"] == before + 1
    exp = ref.fedavg_agg_quality_ref(u, w)
    agg_tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out[0].float(), exp[0].float(),
                               rtol=agg_tol, atol=1e-5)
    for a, b in zip(out[1:], exp[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * P ** 0.5)


def test_kernel_is_deterministic(cuda):
    u = torch.randn(13, 100_003, device=cuda)
    w = torch.softmax(torch.randn(13, device=cuda), 0)
    a = ops.fedavg_agg_quality(u, w)
    b = ops.fedavg_agg_quality(u, w)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_refuses_k_above_max(cuda):
    u = torch.zeros(fedavg_agg.MAX_K + 1, 8, device=cuda)
    with pytest.raises(ValueError, match="K <="):
        ops.fedavg_agg_quality(u, torch.ones(fedavg_agg.MAX_K + 1,
                                             device=cuda))


# ---------------------------------------------------------------------------
# fedavg_agg, and the rounds that launch it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,P", [(1, 1), (3, 10), (13, 255), (13, 256),
                                 (13, 257), (64, 16_385), (100, 4097),
                                 (13, 1_070_794), (7, 1_048_576),
                                 (2100, 33), (3000, 1000)])
def test_fedavg_agg_kernel_matches_plain(cuda, K, P, dtype):
    """K past row 1's 64 and past the 2,048 weights staged at once."""
    g = torch.Generator(device=cuda).manual_seed(K * 131 + P)
    u = torch.randn(K, P, generator=g, device=cuda).to(dtype)
    w = torch.rand(K, generator=g, device=cuda)
    w = w / w.sum()
    before = ops.LAUNCHES["fedavg_agg"]
    got = ops.fedavg_agg(u, w)
    assert ops.LAUNCHES["fedavg_agg"] == before + 1
    exp = ref.fedavg_agg_ref(u, w)
    assert got.dtype == dtype and got.shape == (P,)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), exp.float(), rtol=rtol, atol=1e-5)
    assert torch.equal(got, ops.fedavg_agg(u, w))
    # a base one element past an alignment takes the scalar loads and
    # gives the same sums
    buf = torch.empty(K * P + 1, dtype=dtype, device=cuda)
    shifted = buf[1:].view(K, P)
    shifted.copy_(u)
    assert fedavg_agg.vector_width(shifted) == 1
    assert torch.equal(ops.fedavg_agg(shifted, w), got)


def test_fedavg_agg_kernel_refuses_bad_inputs(cuda):
    u = torch.ones(4, 8, device=cuda)
    w = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fedavg_agg.fedavg_agg(u.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        fedavg_agg.fedavg_agg(torch.ones(8, 4, device=cuda).T, w)
    with pytest.raises(ValueError, match=r"\(K,\)"):
        fedavg_agg.fedavg_agg(u, torch.ones(5, device=cuda))
    with pytest.raises(ValueError, match="K >= 1"):
        fedavg_agg.fedavg_agg(torch.ones(0, 8, device=cuda),
                              torch.ones(0, device=cuda))


def cifar_leaves(cuda, dtype, K=13, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return ({name: torch.randn((K,) + shape, generator=g,
                               device=cuda).to(dtype)
             for name, shape in cnn.param_shapes(cnn.CIFAR_CNN).items()},
            torch.rand(K, generator=g, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedavg_agg_tree_is_one_launch_bit_equal_to_per_leaf(cuda, dtype):
    """The 8 CIFAR_CNN leaves in one launch, each leaf bit-equal to its
    own ``fedavg_agg`` launch, in its per-client shape."""
    tree, w = cifar_leaves(cuda, dtype)
    before = ops.LAUNCHES["fedavg_agg"]
    got = ops.fedavg_agg_tree(tree, w)
    assert ops.LAUNCHES["fedavg_agg"] == before + 1
    for name, leaf in tree.items():
        assert got[name].shape == leaf.shape[1:] and got[name].dtype == dtype
        assert torch.equal(got[name].reshape(-1),
                           fedavg_agg.fedavg_agg(leaf.reshape(13, -1), w))
    assert all(torch.equal(got[n], v)
               for n, v in ops.fedavg_agg_tree(tree, w).items())


@pytest.mark.parametrize("K", [3, 2100])
def test_fedavg_agg_tree_past_the_table_and_across_dtypes(cuda, K):
    """More leaves than a table holds take one launch a table; two dtypes
    a table each; K past the 2,048 weights staged at once; odd widths,
    a one-element leaf and a base off 16 bytes (scalar loads)."""
    g = torch.Generator(device=cuda).manual_seed(K)
    n = fedavg_agg.MAX_LEAVES + 7
    tree = {f"f{i}": torch.randn(K, 1 + 37 * i, generator=g, device=cuda)
            for i in range(n)}
    tree.update({f"b{i}": torch.randn(K, 3, 8 * i + 5, generator=g,
                                      device=cuda).to(torch.bfloat16)
                 for i in range(3)})
    buf = torch.randn(K * 64 + 1, generator=g, device=cuda)
    tree["shifted"] = buf[1:].view(K, 64)
    w = torch.rand(K, generator=g, device=cuda)
    w = w / w.sum()
    before = ops.LAUNCHES["fedavg_agg"]
    got = ops.fedavg_agg_tree(tree, w)
    assert ops.LAUNCHES["fedavg_agg"] == before + 3
    for name, leaf in tree.items():
        want = fedavg_agg.fedavg_agg(leaf.reshape(K, -1).contiguous(), w)
        assert torch.equal(got[name].reshape(-1), want)
        rtol = 2.0 ** -7 if leaf.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(
            got[name].reshape(-1).float(),
            ref.fedavg_agg_ref(leaf.reshape(K, -1), w).float(), rtol=rtol,
            atol=1e-5)


def test_fedavg_agg_tree_refuses_bad_inputs(cuda):
    w = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fedavg_agg.fedavg_agg_leaves({"x": torch.ones(4, 8, device=cuda,
                                                      dtype=torch.half)}, w)
    with pytest.raises(ValueError, match="K=4"):
        fedavg_agg.fedavg_agg_leaves({"x": torch.ones(5, 8, device=cuda)}, w)
    with pytest.raises(ValueError, match="CUDA"):
        fedavg_agg.fedavg_agg_leaves({"x": torch.ones(4, 8)}, w)


def cifar_round_inputs(cuda, K=13, E=2, b=16, seed=0):
    data = make_classification_data("cifar", 600, seed=seed)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 600, size=(K, E, b))
    batches = {"images": torch.as_tensor(data.images[idx], device=cuda),
               "labels": torch.as_tensor(data.labels[idx].astype(np.int64),
                                         device=cuda)}
    w = torch.as_tensor(rng.random(K).astype(np.float32), device=cuda)
    mask = torch.ones(K, device=cuda)
    mask[2] = 0.0
    params = cnn.init_params(cnn.CIFAR_CNN, torch.Generator().manual_seed(seed),
                             cuda)
    return batches, w, mask, params


def test_host_round_launches_fedavg_agg_per_leaf(cuda):
    """``make_fl_round(use_agg_kernel=True)`` at CIFAR_CNN width launches
    the kernel once for all 8 leaves and agrees with the plain round."""
    batches, w, mask, params = cifar_round_inputs(cuda)
    loss = lambda p, b: cnn.loss_fn(cnn.CIFAR_CNN, p, b)
    before = dict(ops.LAUNCHES)
    pk, ik = make_fl_round(loss, local_lr=0.1, use_agg_kernel=True)(
        params, batches, w, mask)
    counts = {n: ops.LAUNCHES[n] - before[n] for n in before}
    pp, ip = make_fl_round(loss, local_lr=0.1, use_agg_kernel=True,
                           kernels=ops.PLAIN)(params, batches, w, mask)
    torch.cuda.synchronize()
    assert {n: c for n, c in counts.items() if c} == {"fedavg_agg": 1}
    for n in pk:
        torch.testing.assert_close(pk[n], pp[n], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ik["q_values"], ip["q_values"], rtol=0,
                               atol=1e-5)
    assert float(ik["q_values"][2]) == 0.0


def test_device_chunk_repeats_under_the_library_pin(cuda):
    """Two identical chunks give bit-equal params and metrics with the
    caller's cuDNN flags at PyTorch's defaults (TF32 allowed, algorithms
    free), which the library leaves as it found them."""
    assert torch.backends.cudnn.allow_tf32 and \
        not torch.backends.cudnn.deterministic
    data = make_classification_data("cifar", 800, seed=3)
    parts = partition_labels(data.labels, 16, "type2", 10, seed=3)
    dd = device_data.DeviceDataset.stage(data, parts, cuda)
    S, K = 2, 13
    rows = torch.as_tensor(np.stack([np.random.default_rng(t).choice(
        16, K, replace=False) for t in range(S)]), device=cuda)
    sched = {"rows": rows, "weights": torch.full((S, K), 1 / K, device=cuda),
             "active": torch.ones(S, K, device=cuda),
             "round_ids": torch.arange(S, device=cuda)}
    params = cnn.init_params(cnn.CIFAR_CNN, torch.Generator().manual_seed(3),
                             cuda)
    loss = lambda p, b: cnn.loss_fn(cnn.CIFAR_CNN, p, b, impl="auto")
    fn = make_fl_rounds_scan(loss, local_lr=0.1, local_steps=2, batch_size=16,
                             dropout_rate=0.1)
    (pa, ia), (pb, ib) = (fn(params, dd, sched, trandom.prng_key(3, cuda))
                          for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert all(torch.equal(ia[k], ib[k]) for k in ia)
    assert torch.backends.cudnn.allow_tf32 and \
        not torch.backends.cudnn.deterministic


# ---------------------------------------------------------------------------
# segmented_topk
# ---------------------------------------------------------------------------

def assert_topk_equal(got, exp):
    """Values bit for bit (NaN included), lanes wherever the value is not
    a -inf padding slot."""
    assert torch.equal(got[0].view(torch.int32), exp[0].view(torch.int32))
    kept = exp[0] != float("-inf")
    assert torch.equal(got[1][kept], exp[1][kept])


def topk_input(S, C, kind, cuda):
    g = torch.Generator(device=cuda).manual_seed(S * 31 + C)
    if kind == "normal":
        return torch.randn(S, C, generator=g, device=cuda)
    if kind == "ties":          # few distinct values: ties at every boundary
        return torch.randint(0, 5, (S, C), generator=g,
                             device=cuda).float() / 4
    if kind == "equal":         # one value: the equals straddle chunks
        return torch.full((S, C), 0.25, device=cuda)
    x = torch.randn(S, C, generator=g, device=cuda)
    if kind == "nan":           # NaN above +inf, then +inf; -inf below all
        x[:, ::7] = float("nan")
        x[:, 3::11] = float("inf")
        x[:, 5::13] = float("-inf")
        return x
    x[:, C // 3:] = float("-inf")  # -inf padded rows
    x[-1] = float("-inf")
    if C > 2:
        x[0, 1], x[0, 2] = -0.0, 0.0
    return x


@pytest.mark.parametrize("kind", ["normal", "ties", "padded", "equal",
                                  "nan"])
@pytest.mark.parametrize("S,C,k", [(3, 1000, 7), (8, 131072, 1),
                                   (8, 131072, 32), (8, 131072, 4096),
                                   (2, 131072, 131072), (5, 9000, 4097),
                                   (1, 1, 1), (4, 77, 100),
                                   # one row over many blocks; k mid-row
                                   (1, 2**20 + 3, 4096),
                                   (1, 2**20 + 3, 2**19 + 1),
                                   # short rows merged from tiles, some
                                   # of padding only
                                   (2, 9000, 2049), (6, 5000, 300),
                                   # odd C: rows off every vector boundary
                                   (13, 100_001, 5003)])
def test_segmented_topk_matches_plain(cuda, S, C, k, kind):
    x = topk_input(S, C, kind, cuda)
    before = ops.LAUNCHES["segmented_topk"]
    got = ops.segmented_topk(x, k)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segmented_topk"] == before + 1
    assert got[0].shape == (S, min(k, C)) and got[1].dtype == torch.int32
    assert_topk_equal(got, ref.segmented_topk_ref(x, k))


def test_segmented_topk_is_deterministic(cuda):
    x = topk_input(8, 131072, "ties", cuda)
    a, b = ops.segmented_topk(x, 4096), ops.segmented_topk(x, 4096)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_topk_sparsify_is_deterministic(cuda):
    x = codec_input(13, MAIN_P, "ties", cuda)
    a = ops.topk_sparsify(x, MAIN_TOPK)
    for _ in range(3):
        b = ops.topk_sparsify(x, MAIN_TOPK)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_segmented_topk_refuses_bad_inputs(cuda):
    with pytest.raises(ValueError, match="float32"):
        ops.segmented_topk(torch.zeros(2, 8, dtype=torch.float64,
                                       device=cuda), 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.segmented_topk(torch.zeros(8, 2, device=cuda).T, 3)
    with pytest.raises(ValueError, match="k >= 1"):
        segmented_topk.segmented_topk(torch.zeros(2, 8, device=cuda), 0)


# ---------------------------------------------------------------------------
# mkp_utility
# ---------------------------------------------------------------------------

def mkp_input(n, m, cuda):
    g = torch.Generator(device=cuda).manual_seed(n * 131 + m)
    v = torch.rand(n, generator=g, device=cuda) * 9 + 1
    w = torch.randint(0, 30, (n, m), generator=g, device=cuda).float()
    r = 0.3 * w.sum(0) + torch.rand(m, generator=g, device=cuda)
    r[0] = 0.0                                     # an exhausted knapsack
    sel = torch.rand(n, generator=g, device=cuda) < 0.7
    return v, w, r, sel


@pytest.mark.parametrize("n", [1, 19, 3846, 100003])
@pytest.mark.parametrize("m", [1, 10, 64, 300])
def test_mkp_utility_matches_plain_bitwise(cuda, n, m):
    args = mkp_input(n, m, cuda)
    before = ops.LAUNCHES["mkp_utility"]
    got = ops.mkp_utility(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mkp_utility"] == before + 1
    assert torch.equal(got, ref.mkp_utility_ref(*args))


def test_mkp_utility_keeps_a_nan_penalty(cuda):
    """A NaN penalty (an infinite weight under an infinite capacity:
    inf * 0) stays NaN, as ``torch.clamp_min`` and ``jnp.maximum`` keep
    it, so the utility is NaN (the kernel once clamped it to 1e-12)."""
    v, w, r, sel = mkp_input(19, 10, cuda)
    w[3], r[1], sel[3] = 0.0, float("inf"), True
    w[3, 1] = float("inf")
    got, exp = ops.mkp_utility(v, w, r, sel), ref.mkp_utility_ref(v, w, r, sel)
    assert torch.isnan(exp[3]) and torch.isnan(got[3])
    keep = ~torch.isnan(exp)
    assert torch.equal(got[keep], exp[keep])


def test_mkp_utility_is_deterministic(cuda):
    args = mkp_input(3846, 10, cuda)
    assert torch.equal(ops.mkp_utility(*args), ops.mkp_utility(*args))


def test_mkp_utility_refuses_bad_inputs(cuda):
    v, w, r, sel = mkp_input(10, 3, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        mkp_utility.mkp_utility(v.cpu(), w, r, sel)
    with pytest.raises(ValueError, match="bool"):
        ops.mkp_utility(v, w, r, sel.float())
    with pytest.raises(ValueError, match="float32"):
        ops.mkp_utility(v.double(), w, r, sel)
    with pytest.raises(ValueError, match="shapes"):
        ops.mkp_utility(v, w, r[:2], sel)


def test_device_mkp_greedy_equals_cpu(cuda):
    rng = np.random.default_rng(4)
    w = rng.integers(0, 30, size=(500, 10)).astype(float)
    v = w.sum(axis=1) + rng.uniform(0, 5, 500)
    cap = 0.05 * w.sum(axis=0)
    a = engine.solve_mkp_greedy_device(v, w, cap, 13, device=cuda)
    b = engine.solve_mkp_greedy_device(v, w, cap, 13, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def greedy_instance(n, m, kind, seed=0):
    """An MKP instance as numpy f32 (values, weights, capacities).
    ``random``: integer weights, capacities at 0.4 of the column sums;
    ``ties``: values the weights' sums and one power-of-two capacity for
    every knapsack, so the first utilities tie exactly; ``all``: every
    item fits; ``nofit``: none does; ``nan`` / ``inf``: one fitting item's
    value is NaN / +inf; ``zero``: one item weighs nothing (its utility is
    v / 1e-12); ``nan_penalty``: an infinite capacity and an infinite
    weight, whose penalty inf * 0 is NaN."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 30, (n, m)).astype(np.float32)
    v = (w.sum(1) + rng.uniform(0, 5, n)).astype(np.float32)
    cap = (0.4 * w.sum(0) + 1).astype(np.float32)
    j = n // 3
    if kind == "ties":
        v, cap = w.sum(1), np.full(m, 64.0, np.float32)
    elif kind == "all":
        cap = w.sum(0) + 1
    elif kind == "nofit":
        w += 1
        cap = np.full(m, 0.5, np.float32)
    elif kind in ("nan", "inf"):
        w[j] = 1
        v[j] = np.nan if kind == "nan" else np.inf
    elif kind == "zero":
        w[j] = 0
    elif kind == "nan_penalty":
        cap[0], w[j] = np.inf, 1
        w[j, 0] = np.inf
    return v, w, cap


# (n, m, max_size, kind): the clusters greedy_blocks takes from n (1
# block to 512 items, 700 -> 2, 1,100 -> 3, 2,500 -> 5, 3,000 -> 6, stage
# 2's 3,846 -> 8), past the cluster's shared memory (50,000 x 10 and up:
# rows read from device memory), m past the register columns (13, 17,
# 300) and past the shared knapsack terms (2,500), ragged m, and the
# special utilities
GREEDY_CASES = [
    (1, 1, None, "random"), (1, 5, 3, "nofit"), (1, 3, None, "nan"),
    (19, 10, None, "all"), (19, 10, None, "ties"), (200, 7, 30, "nan"),
    (200, 7, 30, "inf"), (200, 13, 30, "zero"),
    (200, 10, 30, "nan_penalty"), (200, 10, 250, "all"),
    (200, 10, 30, "nofit"), (700, 10, 13, "random"),
    (1100, 10, 13, "ties"), (2500, 10, 13, "random"),
    (3000, 17, 13, "all"), (3846, 10, 13, "random"),
    (3846, 10, 13, "ties"), (3846, 17, 13, "random"),
    (3846, 10, 13, "all"), (15_000, 10, 13, "random"),
    (15_000, 10, 13, "ties"), (50_000, 10, 13, "random"),
    (100_003, 64, 13, "random"), (5000, 300, 13, "random"),
    (50, 2500, 5, "random"), (50, 2500, 5, "all")]


@pytest.mark.parametrize("n,m,max_size,kind", GREEDY_CASES, ids=str)
def test_mkp_greedy_matches_plain_bitwise(cuda, n, m, max_size, kind):
    v, w, cap = (torch.as_tensor(a).to(cuda)
                 for a in greedy_instance(n, m, kind, seed=n + m))
    before = ops.LAUNCHES["mkp_greedy"]
    got = ops.mkp_greedy(v, w, cap, max_size)
    assert ops.LAUNCHES["mkp_greedy"] == before + 1
    exp = ref.mkp_greedy_ref(v, w, cap, max_size)
    torch.cuda.synchronize()
    assert torch.equal(got[0], exp[0])
    assert torch.equal(got[1].view(torch.int32), exp[1].view(torch.int32))
    if kind in ("nan", "inf", "nofit", "nan_penalty"):
        assert not got[0].any()       # the first pick is not finite


def test_mkp_greedy_blocks_cover_the_pool(cuda):
    """A block per 512 items, at least the blocks whose shared memory
    holds the pool (a row of 2,500 knapsacks is 10 KB, 23 rows a block),
    at most one portable cluster of 8 and at most n."""
    assert mkp_utility.greedy_blocks(1, 10) == 1
    assert mkp_utility.greedy_blocks(512, 10) == 1
    assert mkp_utility.greedy_blocks(1000, 10) == 2
    # the clusters GREEDY_CASES reach through n
    assert [mkp_utility.greedy_blocks(n, 10) for n in (700, 1100, 2500)] \
        == [2, 3, 5]
    assert mkp_utility.greedy_blocks(3000, 17) == 6
    assert mkp_utility.greedy_blocks(3846, 10) == mkp_utility.MAX_BLOCKS
    assert mkp_utility.greedy_blocks(100_003, 64) == mkp_utility.MAX_BLOCKS
    assert mkp_utility.greedy_blocks(50, 2500) == 3
    assert mkp_utility.greedy_blocks(5, 20_000) == 3       # 2 rows a block
    assert mkp_utility.greedy_blocks(3, 100_000) == 3      # n caps it


def test_mkp_greedy_repeats_and_replays_in_a_cuda_graph(cuda):
    v, w, cap = (torch.as_tensor(a).to(cuda)
                 for a in greedy_instance(3846, 10, "random", seed=1))
    first = ops.mkp_greedy(v, w, cap, 13)
    again = ops.mkp_greedy(v, w, cap, 13)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.mkp_greedy(v, w, cap, 13)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.mkp_greedy(v, w, cap, 13)
    for seed in (2, 3):
        for t, a in zip((v, w, cap), greedy_instance(3846, 10, "random", seed)):
            t.copy_(torch.as_tensor(a))
        graph.replay()
        exp = ref.mkp_greedy_ref(v, w, cap, 13)
        torch.cuda.synchronize()
        assert torch.equal(out[0], exp[0]) and torch.equal(out[1], exp[1])


def test_mkp_greedy_refuses_bad_inputs(cuda):
    v, w, cap = (torch.as_tensor(a).to(cuda)
                 for a in greedy_instance(10, 3, "random"))
    with pytest.raises(ValueError, match="CUDA"):
        mkp_utility.mkp_greedy(v.cpu(), w, cap)
    with pytest.raises(ValueError, match="float32"):
        ops.mkp_greedy(v.double(), w, cap)
    with pytest.raises(ValueError, match="shapes"):
        ops.mkp_greedy(v, w, cap[:2])
    with pytest.raises(ValueError, match="contiguous"):
        ops.mkp_greedy(v, w.t().contiguous().t(), cap)
    with pytest.raises(ValueError, match="max_size"):
        ops.mkp_greedy(v, w, cap, -1)
    with pytest.raises(ValueError, match="n, m"):
        ops.mkp_greedy(v, w[:, :1].reshape(10), cap)


def test_device_mkp_greedy_is_one_launch_a_solve(cuda):
    v, w, cap = greedy_instance(3846, 10, "random", seed=5)
    before = dict(ops.LAUNCHES)
    a = engine.solve_mkp_greedy_device(v, w, cap, 13, device=cuda)
    assert ops.LAUNCHES["mkp_greedy"] == before["mkp_greedy"] + 1
    assert ops.LAUNCHES["mkp_utility"] == before["mkp_utility"]
    b = engine.solve_mkp_greedy_device(v, w, cap, 13, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].sum() == 13


# ---------------------------------------------------------------------------
# the batched stage-1 greedy (the intake below the fleet route)
# ---------------------------------------------------------------------------

def intake_args(integer_cost):
    pool = ClientPoolState.random(100_000, 10, np.random.default_rng(5),
                                  integer_cost=integer_cost)
    ths = [np.full(9, 0.05)] * 4 + [np.full(9, 0.2)] * 4
    valid = np.stack([pool.threshold_mask(th) for th in ths])
    budgets = np.array([7_888.94 * f for f in (0.5, 1.0, 2.0, 4.0)] * 2)
    return pool.overall, pool.costs, budgets, valid


def test_batch_auto_is_numpy_on_the_card(cuda):
    args = intake_args(True)
    for a, b in zip(engine.greedy_knapsack_batch(*args),
                    engine.greedy_knapsack_batch(*args, backend="numpy")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("integer_cost", [True, False])
def test_device_batch_equals_numpy_at_intake_shape(cuda, integer_cost):
    """8 tasks over 100,000 clients. Integer costs make the f32 prefix
    sums exact, so the card's batch picks what the f64 numpy batch
    picks; on real-valued costs f32 rounding could move a task's stop
    by a client, and on this seeded pool it does not."""
    args = intake_args(integer_cost)
    got = engine.greedy_knapsack_batch(*args, backend="device", device=cuda)
    exp = engine.greedy_knapsack_batch(*args, backend="numpy")
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])
    np.testing.assert_array_equal(got[2], exp[2])


# ---------------------------------------------------------------------------
# the fleet path
# ---------------------------------------------------------------------------

def test_hierarchical_equals_flat_at_full_shards(cuda):
    pool = ClientPoolState.random(300_000, 10, np.random.default_rng(3))
    th = np.full(9, 0.05)
    mirror = pool.device_mirror(shard_cap=131072, device=cuda)
    assert mirror.num_shards == 3
    for budget in (500.0, 20_000.0):
        stats = {}
        rows, ts, tc, nv = engine.hierarchical_greedy_knapsack(
            pool, budget, th, stats=stats)
        frows, fts, ftc, fnv = engine._flat_pool_greedy(pool, budget, th)
        assert stats["path"] == "frontier"
        np.testing.assert_array_equal(rows, frows)
        assert (ts, tc, nv) == (fts, ftc, fnv)


# ---------------------------------------------------------------------------
# the codec kernels of the compressed update plane
# ---------------------------------------------------------------------------

MAIN_P, MAIN_TOPK = 1_070_794, 53_540     # CIFAR_CNN; k at topk:0.05


def codec_input(K, P, kind, cuda):
    """Unit normals; ``ties``: halves in -1.5..1.5 with signed zeros;
    ``zeros``: zero first halves, row 0 ending in +-amax."""
    g = torch.Generator(device=cuda).manual_seed(K * 1009 + P)
    if kind == "ties":
        x = torch.randint(-3, 4, (K, P), generator=g, device=cuda) / 2.0
        x[0, : min(P, 2)] = torch.tensor([-0.0, 0.0], device=cuda)[:P]
        return x
    if kind == "equal":         # one magnitude, both signs
        return (torch.randint(0, 2, (K, P), generator=g, device=cuda)
                - 0.5).float()
    x = torch.randn(K, P, generator=g, device=cuda)
    if kind == "nan":           # |NaN| above +-inf above the rest
        x[:, ::7] = float("nan")
        x[:, 3::11] = float("inf")
        x[:, 5::13] = float("-inf")
    if kind == "zeros":
        x[:, : max(1, P // 2)] = 0.0
        if P >= 4:
            amax = x[0].abs().max()
            x[0, -2], x[0, -1] = amax, -amax
    return x


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "equal",
                                  "nan"])
@pytest.mark.parametrize("K,P,k", [(1, 7, 1), (1, 7, 7), (13, 4097, 1),
                                   (13, 4097, 4097), (3, 100_003, 777),
                                   (13, MAIN_P, MAIN_TOPK),
                                   # one row over many blocks
                                   (1, 2**20 + 3, 52_429),
                                   (13, MAIN_P, MAIN_P),
                                   # a short row merged from tiles
                                   (1, 100_003, 3000),
                                   # odd P: rows off every vector boundary
                                   (13, 100_001, 5003)])
def test_topk_sparsify_matches_plain(cuda, K, P, k, kind):
    x = codec_input(K, P, kind, cuda)
    before = ops.LAUNCHES["topk_sparsify"]
    got = ops.topk_sparsify(x, k)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_sparsify"] == before + 1
    exp = ref.topk_sparsify_ref(x, k)
    assert torch.equal(got[0].view(torch.int32), exp[0].view(torch.int32))
    assert torch.equal(got[1], exp[1])


@pytest.mark.parametrize("name", ["segmented_topk", "topk_sparsify"])
def test_topk_replays_in_a_cuda_graph(cuda, name):
    """Captured once, replayed on new inputs in the same memory: each
    replay equals an uncaptured call (scratch is zeroed on the stream,
    nothing is read back to the host)."""
    op = getattr(ops, name)
    S, C, k = (8, 131072, 4096) if name == "segmented_topk" else \
        (13, MAIN_P, MAIN_TOPK)
    x = topk_input(S, C, "ties", cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(x, k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = op(x, k)
    for kind in ("ties", "normal", "padded"):
        x.copy_(topk_input(S, C, kind, cuda))
        graph.replay()
        exp = op(x, k)
        torch.cuda.synchronize()
        assert torch.equal(out[0], exp[0]) and torch.equal(out[1], exp[1])


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("chunk", [100, 128, 256, 512])
@pytest.mark.parametrize("K,P", [(1, 7), (13, 4097), (13, MAIN_TOPK),
                                 (13, MAIN_P)])
def test_int8_codec_kernels_match_plain(cuda, K, P, chunk, kind):
    x = codec_input(K, P, kind, cuda)
    before = dict(ops.LAUNCHES)
    v, s = ops.quantize_i8(x, chunk)
    ev, es = ref.quantize_i8_ref(x, chunk)
    d = ops.dequantize_i8(v, s, chunk)
    w = torch.softmax(torch.arange(K, dtype=torch.float32, device=cuda), 0)
    agg = ops.fedavg_agg_quality_i8(v, s, w, chunk)
    torch.cuda.synchronize()
    for name in ("quantize_i8", "dequantize_i8", "fedavg_agg_quality_i8"):
        assert ops.LAUNCHES[name] == before[name] + 1
    assert torch.equal(v, ev) and torch.equal(s, es)
    assert torch.equal(d, ref.dequantize_i8_ref(ev, es, chunk))
    eagg = ref.fedavg_agg_quality_i8_ref(ev, es, w, chunk)
    torch.testing.assert_close(agg[0], eagg[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(agg[1:], eagg[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * P ** 0.5)
    if kind == "zeros" and P >= 1024:
        assert (s[:, 0] == 0).all()
        assert int(v[0, -2]) == 127 and int(v[0, -1]) == -127


def test_codec_kernels_repeat_and_refuse_bad_inputs(cuda):
    x = codec_input(13, 100_003, "ties", cuda)
    a, b = ops.topk_sparsify(x, 5000), ops.topk_sparsify(x, 5000)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    v, s = ops.quantize_i8(x)
    w = torch.full((13,), 1 / 13, device=cuda)
    for p, q in zip(ops.fedavg_agg_quality_i8(v, s, w),
                    ops.fedavg_agg_quality_i8(v, s, w)):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="float32"):
        kcomp.quantize_i8(x.double())
    with pytest.raises(ValueError, match="chunk"):
        kcomp.quantize_i8(x, 0)
    with pytest.raises(ValueError, match="scales"):
        kcomp.dequantize_i8(v, s[:, 1:])
    with pytest.raises(ValueError, match="K <="):
        kcomp.fedavg_agg_quality_i8(
            torch.zeros(fedavg_agg.MAX_K + 1, 8, dtype=torch.int8,
                        device=cuda),
            torch.zeros(fedavg_agg.MAX_K + 1, 1, device=cuda),
            torch.ones(fedavg_agg.MAX_K + 1, device=cuda))
    with pytest.raises(ValueError, match="k >= 1"):
        kcomp.topk_sparsify(x, 0)


@pytest.mark.parametrize("text", ["int8", "topk:0.05+int8"])
def test_compressed_chunk_kernels_vs_plain(cuda, text):
    data = make_classification_data("mnist", 600, seed=2)
    parts = partition_labels(data.labels, 10, "type2", 10, seed=2)
    dd = device_data.DeviceDataset.stage(data, parts, cuda)
    S, K = 3, 6
    rows = torch.as_tensor(np.stack([np.random.default_rng(t).choice(
        10, K, replace=False) for t in range(S)]), device=cuda)
    sched = {"rows": rows, "weights": torch.full((S, K), 1 / K, device=cuda),
             "active": torch.ones(S, K, device=cuda),
             "round_ids": torch.arange(S, device=cuda)}
    params = cnn.init_params(cnn.MNIST_CNN, torch.Generator().manual_seed(2),
                             cuda)
    opt = optim.fedadam(0.01)
    kw = dict(local_lr=0.1, local_steps=2, batch_size=8, dropout_rate=0.2,
              compression=text, server_opt=opt)
    loss = lambda p, b: cnn.loss_fn(cnn.MNIST_CNN, p, b)
    carry = (params, opt.init(params))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = dict(ops.LAUNCHES)
        (pk, _), ik = make_fl_rounds_scan(loss, **kw)(
            carry, dd, sched, trandom.prng_key(2, cuda))
        counts = {n: ops.LAUNCHES[n] - before[n] for n in before}
        (pp, _), ip = make_fl_rounds_scan(loss, kernels=ops.PLAIN, **kw)(
            carry, dd, sched, trandom.prng_key(2, cuda))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    want = ({"quantize_i8", "fedavg_agg_quality_i8"} if text == "int8" else
            {"topk_sparsify", "quantize_i8", "dequantize_i8",
             "fedavg_agg_quality"})
    assert {n for n, c in counts.items() if c} == want
    assert all(counts[n] == S for n in want)
    assert torch.equal(ik["masks"], ip["masks"])
    p = sum(v.numel() for v in params.values())
    per_client = bytes_per_client(CompressionSpec.parse(text), p)
    assert torch.equal(ik["bytes"], ip["bytes"])
    assert torch.equal(ik["bytes"], ik["masks"].sum(1) * per_client)
    change = max(float((pp[n] - params[n]).abs().max()) for n in params)
    off = 0
    for n in params:
        err = (pk[n] - pp[n]).abs()
        off += int((err > 1e-5 + 1e-4 * pp[n].abs()).sum())
        assert float(err.max()) <= 0.5 * change
    assert off <= 0.001 * p
    torch.testing.assert_close(ik["q_values"], ip["q_values"], rtol=0,
                               atol=1e-4)


def fma_f32(a, b, c):
    """fmaf(a, b, c) over f32 arrays, rounded once: a * b is exact in f64,
    TwoSum gives the f64 sum's error, and a sum that lands on an f32
    midpoint goes the way the error points."""
    p, c = a.astype(np.float64) * b.astype(np.float64), c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf),
                                     np.float32(-np.inf)).astype(np.float32))
    mid = (s != r) & ((r.astype(np.float64) + other) * 0.5 == s)
    up = (err > 0) == (other > r)
    return np.where(mid & (err != 0) & up, other, r)


def i8_agg_fmaf(v, s, w, chunk):
    """agg as the int8 kernel sums it: x = float(V) * S rounded once, then
    fmaf(w_k, x, agg) over the clients in order, column by column."""
    v, s, w = v.cpu().numpy(), s.cpu().numpy(), w.cpu().numpy()
    K, P = v.shape
    cols = np.arange(P) // chunk
    agg = np.zeros(P, np.float32)
    for k in range(K):
        x = v[k].astype(np.float32) * s[k, cols]
        agg = fma_f32(np.full(P, w[k], np.float32), x, agg)
    return torch.as_tensor(agg)


# K from 1 to 64 (each accumulator size, below and past the 16 rows held
# in registers), P from 1 to the main path's (ragged tails of every
# length, and rows off 16-byte alignment)
I8_SHAPES = [(1, 1), (1, 7), (3, 15), (2, 16), (13, 17), (5, 100), (13, 4097),
             (17, 5000), (33, 3001), (64, 1000), (13, 100_003), (13, MAIN_P)]


@pytest.mark.parametrize("chunk", [100, 128, 256, 512])
@pytest.mark.parametrize("K,P", I8_SHAPES, ids=str)
def test_fedavg_agg_quality_i8_matches_plain(cuda, K, P, chunk):
    x = codec_input(K, P, "normal", cuda)
    v, s = (t.contiguous() for t in ref.quantize_i8_ref(x, chunk))
    w = torch.softmax(torch.randn(K, generator=torch.Generator(
        device=cuda).manual_seed(K), device=cuda), 0)
    before = ops.LAUNCHES["fedavg_agg_quality_i8"]
    got = ops.fedavg_agg_quality_i8(v, s, w, chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedavg_agg_quality_i8"] == before + 1
    exp = ref.fedavg_agg_quality_i8_ref(v, s, w, chunk)
    torch.testing.assert_close(got[0], exp[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(got[1:], exp[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * P ** 0.5)
    assert torch.equal(got[0].cpu(), i8_agg_fmaf(v, s, w, chunk))


def test_fedavg_agg_quality_i8_repeats_and_replays_in_a_cuda_graph(cuda):
    x = codec_input(13, MAIN_P, "ties", cuda)
    v, s = ops.quantize_i8(x)
    w = torch.softmax(torch.arange(13, dtype=torch.float32, device=cuda), 0)
    first = ops.fedavg_agg_quality_i8(v, s, w)
    for _ in range(3):
        again = ops.fedavg_agg_quality_i8(v, s, w)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.fedavg_agg_quality_i8(v, s, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = [ops.fedavg_agg_quality_i8(v, s, w) for _ in range(3)]
    for kind in ("normal", "zeros"):
        nv, ns = ops.quantize_i8(codec_input(13, MAIN_P, kind, cuda))
        v.copy_(nv)
        s.copy_(ns)
        graph.replay()
        exp = ops.fedavg_agg_quality_i8(v, s, w)
        torch.cuda.synchronize()
        for o in out:
            assert all(torch.equal(a, b) for a, b in zip(o, exp))


def test_fedavg_agg_quality_i8_graphs_replay_side_by_side(cuda):
    """Two graphs captured on ``torch.cuda.graph``'s one capture stream,
    replayed at once on two streams beside a direct call: each call has
    its own last-block ticket, so no sum is lost or mixed."""
    inputs = []
    for kind in ("normal", "ties"):
        v, s = ops.quantize_i8(codec_input(13, 100_003, kind, cuda))
        w = torch.softmax(torch.randn(13, generator=torch.Generator(
            device=cuda).manual_seed(len(kind)), device=cuda), 0)
        inputs.append((v, s, w))
    want = [ops.fedavg_agg_quality_i8(*a) for a in inputs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in inputs:
            ops.fedavg_agg_quality_i8(*a)
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    for a in inputs:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append([ops.fedavg_agg_quality_i8(*a) for _ in range(8)])
        graphs.append(graph)
    streams = [torch.cuda.Stream() for _ in graphs]
    for _ in range(20):
        for st, graph in zip(streams, graphs):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                graph.replay()
        direct = ops.fedavg_agg_quality_i8(*inputs[0])
        for st in streams:
            torch.cuda.current_stream().wait_stream(st)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(direct, want[0]))
        for out, exp in zip(outs, want):
            for o in out:
                assert all(torch.equal(a, b) for a, b in zip(o, exp))


def test_fedavg_agg_quality_i8_refuses_bad_inputs(cuda):
    v = torch.zeros(3, 100, dtype=torch.int8, device=cuda)
    s = torch.ones(3, 1, device=cuda)
    w = torch.full((3,), 1 / 3, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        kcomp.fedavg_agg_quality_i8(v.cpu(), s, w)
    with pytest.raises(ValueError, match="int8"):
        kcomp.fedavg_agg_quality_i8(v.float(), s, w)
    with pytest.raises(ValueError, match="scales"):
        kcomp.fedavg_agg_quality_i8(v, s, w, chunk=50)
    with pytest.raises(ValueError, match="chunk"):
        kcomp.fedavg_agg_quality_i8(v, s, w, chunk=0)
    with pytest.raises(ValueError, match="weights"):
        kcomp.fedavg_agg_quality_i8(v, s, w[:2])
    with pytest.raises(ValueError, match="K <= 64"):
        kcomp.fedavg_agg_quality_i8(
            torch.zeros(65, 100, dtype=torch.int8, device=cuda),
            torch.ones(65, 1, device=cuda), torch.ones(65, device=cuda))


# ---------------------------------------------------------------------------
# The serve path's kernels: rmsnorm, swiglu, flash_attention
# ---------------------------------------------------------------------------

SERVE_TOL = {
    "rmsnorm": {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -6, 1e-6)},
    "swiglu": {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)},
    "flash_attention": {torch.float32: (2e-5, 2e-5),
                        torch.bfloat16: (2e-2, 2e-2)}}


def assert_serve_close(name, got, want):
    rtol, atol = SERVE_TOL[name][want.dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def randn(shape, dtype, seed, device, scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1), (8, 64), (3, 5, 128), (4, 50),
                                   (7, 960), (8192, 960), (2, 4100),
                                   (8, 1600), (8, 2048), (8, 2056)])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    x = randn(shape, dtype, 1, cuda, 3.0)
    s = randn(shape[-1:], dtype, 2, cuda)
    before = ops.LAUNCHES["rmsnorm"]
    got = ops.rmsnorm(x, s)
    assert ops.LAUNCHES["rmsnorm"] == before + 1
    assert_serve_close("rmsnorm", got, ref.rmsnorm_ref(x, s))
    assert torch.equal(got, ops.rmsnorm(x, s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,F", [(16, 32, 48), (7, 64, 24),
                                   (64, 128, 256), (5, 50, 37), (1, 1, 1),
                                   (8, 960, 2560), (1000, 960, 2560),
                                   (130, 200, 70)])
def test_swiglu_kernel_matches_plain(cuda, M, D, F, dtype):
    x = randn((M, D), dtype, 3, cuda)
    wg = randn((D, F), dtype, 4, cuda, 0.1)
    wu = randn((D, F), dtype, 5, cuda, 0.1)
    before = ops.LAUNCHES["swiglu"]
    got = ops.swiglu(x, wg, wu)
    assert ops.LAUNCHES["swiglu"] == before + 1
    assert_serve_close("swiglu", got, ref.swiglu_ref(x, wg, wu))
    x3 = x.reshape(1, M, D)
    assert torch.equal(ops.swiglu(x3, wg, wu), got.reshape(1, M, F))


# swiglu's serve shapes and ragged ones for its Hopper routes: M off 128,
# D off 64, F off 128, two passes of rows at decode, the split-K route's
# largest D, one row and one 8 x 8 tile
SWIGLU_ROUTE_CASES = [(8192, 960, 2560), (8, 960, 2560), (8192, 1600, 5504),
                      (4, 1600, 5504), (1000, 200, 72), (300, 1608, 136),
                      (12, 1000, 520), (3, 2048, 64), (1, 8, 8), (129, 8, 8),
                      (16, 32, 48), (17, 64, 136)]


@pytest.mark.parametrize("M,D,F", SWIGLU_ROUTE_CASES, ids=str)
def test_swiglu_every_route_matches_plain(cuda, M, D, F):
    """bf16: the kernel ``route`` picks, and every other kernel that takes
    the operands (below prefill size), against the plain version; every
    call repeats bit for bit."""
    x = randn((M, D), torch.bfloat16, 12, cuda)
    wg = randn((D, F), torch.bfloat16, 13, cuda, D ** -0.5)
    wu = randn((D, F), torch.bfloat16, 14, cuda, D ** -0.5)
    want = ref.swiglu_ref(x, wg, wu)
    kinds = kswiglu._routes(torch.bfloat16, M, D, F, True)
    assert kinds[0] == kswiglu.route(torch.bfloat16, M, D, F, True)
    for kind in kinds if M <= 1024 else kinds[:1]:
        got = kswiglu.swiglu(x, wg, wu, kernel=kind)
        assert_serve_close("swiglu", got, want)
        assert torch.equal(got, kswiglu.swiglu(x, wg, wu, kernel=kind))


def test_swiglu_routes_on_the_card(cuda):
    """The serve shapes take the Hopper routes; D % 8 != 0 and a base off
    16 bytes take mma.sync; a kernel that does not take the operands is
    refused."""
    bf = torch.bfloat16
    shapes = {(8192, 960, 2560): "wgmma", (8, 960, 2560): "splitk",
              (8192, 1600, 5504): "wgmma", (4, 1600, 5504): "splitk",
              (64, 962, 72): "mma"}
    for (M, D, F), kind in shapes.items():
        x = torch.zeros(M, D, dtype=bf, device=cuda)
        w = torch.zeros(D, F, dtype=bf, device=cuda)
        assert kswiglu.route(bf, M, D, F, build.aligned16(x, w)) == kind
    buf = torch.zeros(8 * 960 + 1, dtype=bf, device=cuda)
    x = buf[1:].view(8, 960)
    wg = randn((960, 64), bf, 15, cuda, 0.03)
    assert not build.aligned16(x)
    assert_serve_close("swiglu", ops.swiglu(x, wg, wg),
                       ref.swiglu_ref(x, wg, wg))
    with pytest.raises(ValueError, match="does not take"):
        kswiglu.swiglu(torch.zeros(8, 962, dtype=bf, device=cuda),
                       torch.zeros(962, 64, dtype=bf, device=cuda),
                       torch.zeros(962, 64, dtype=bf, device=cuda),
                       kernel="wgmma")
    with pytest.raises(ValueError, match="does not take"):
        kswiglu.swiglu(torch.zeros(8, 64, device=cuda),
                       torch.zeros(64, 64, device=cuda),
                       torch.zeros(64, 64, device=cuda), kernel="splitk")


# (B, H, G, Sq, Sk, hd, causal, window): the sweep of tests/test_kernels.py,
# then the serve shape's head size at ragged lengths, the CUDA-core
# kernel's head sizes (48, 256), the Hopper kernel's largest (128), and its
# edges: Hymba's prefill at batch 1 (a 1,024 window over 2,048 keys), and
# at hd 128 Sq < Sk under a window, Sq = 1 and a ragged non-causal S
FA_CASES = [(1, 2, 2, 32, 32, 16, True, 0), (2, 4, 2, 64, 64, 32, True, 0),
            (1, 8, 1, 48, 48, 64, True, 0), (1, 2, 1, 64, 64, 16, True, 8),
            (1, 2, 1, 64, 64, 16, True, 16), (2, 4, 2, 1, 128, 32, True, 0),
            (1, 2, 2, 32, 32, 16, False, 0), (1, 2, 2, 40, 40, 16, True, 0),
            (2, 15, 5, 300, 300, 64, True, 0),
            (1, 15, 5, 200, 333, 64, True, 100),
            (1, 4, 2, 70, 70, 64, False, 30), (1, 4, 4, 1, 333, 64, True, 64),
            (1, 2, 1, 50, 50, 48, True, 0), (1, 2, 2, 33, 65, 256, True, 0),
            (1, 4, 2, 129, 129, 128, True, 0),
            (1, 25, 5, 2048, 2048, 64, True, 1024),
            (1, 4, 2, 100, 300, 128, True, 64),
            (2, 4, 2, 1, 333, 128, True, 0),
            (1, 4, 2, 77, 77, 128, False, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    B, H, G, Sq, Sk, hd, causal, window = case
    q = randn((B, H, Sq, hd), dtype, 6, cuda)
    k = randn((B, G, Sk, hd), dtype, 7, cuda)
    v = randn((B, G, Sk, hd), dtype, 8, cuda)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert_serve_close("flash_attention", got, want)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bshd_reads_views_in_place(cuda, dtype, hd):
    """The models' (B, S, H, hd) tensors go in as transposed views; the
    output comes back (B, S, H, hd) contiguous, no copy made."""
    q = randn((2, 100, 15, hd), dtype, 9, cuda)
    k = randn((2, 100, 5, hd), dtype, 10, cuda)
    v = randn((2, 100, 5, hd), dtype, 11, cuda)
    assert all(kflash.tma_describable(t.transpose(1, 2)) for t in (q, k, v))
    got = ops.flash_attention_bshd(q, k, v, causal=True, window=0)
    assert got.is_contiguous() and got.shape == q.shape
    assert_serve_close("flash_attention", got,
                       ops.PLAIN.flash_attention_bshd(q, k, v, causal=True,
                                                      window=0))


def test_serve_kernels_refuse_bad_inputs(cuda):
    x = torch.ones(4, 64, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        krms.rmsnorm(x.half(), torch.ones(64, device=cuda).half())
    with pytest.raises(ValueError, match="same type"):
        krms.rmsnorm(x, torch.ones(64, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"\(D,\)"):
        krms.rmsnorm(x, torch.ones(65, device=cuda))
    w = torch.ones(64, 32, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kswiglu.swiglu(x.double(), w.double(), w.double())
    with pytest.raises(ValueError, match=r"\(D, F\)"):
        kswiglu.swiglu(x, w, torch.ones(64, 31, device=cuda))
    q = torch.ones(1, 4, 8, 64, device=cuda)
    kv = torch.ones(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kflash.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="hd <= 256"):
        big = torch.ones(1, 2, 8, 320, device=cuda)
        kflash.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="not a multiple"):
        kflash.flash_attention(q, torch.ones(1, 3, 8, 64, device=cuda),
                               torch.ones(1, 3, 8, 64, device=cuda))
    with pytest.raises(ValueError, match="no key"):
        kflash.flash_attention(q, kv[:, :, :4], kv[:, :, :4])
    with pytest.raises(ValueError, match="one type"):
        kflash.flash_attention(q, kv.to(torch.bfloat16), kv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_serve_kernels_vs_plain(cuda, dtype):
    """A reduced SmolLM (two layers, GQA) on the card: prefill and 4
    teacher-forced decode steps through the kernels against
    ``kernels=ops.PLAIN`` on the same weights, with exact launch counts.
    Logits of two layers: f32 within 1e-4; bf16 within 5e-2 (bf16
    activations rounded at other places through two layers)."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              use_kernels=True, dtype=dtype, num_kv_heads=2)
    params = T.init_params(cfg, torch.Generator(cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (3, 40), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    for name in ("rmsnorm", "swiglu", "flash_attention"):
        ops.LAUNCHES[name] = 0
    runs = []
    for kernels in (None, ops.PLAIN):
        logits, cache, _ = T.prefill(cfg, params, toks, kernels=kernels)
        cache = T.grow_cache(cfg, cache, 4)
        outs = [logits]
        for step in range(4):
            logits, cache = T.decode_step(cfg, params, toks[:, step:step + 1],
                                          cache, 40 + step, kernels=kernels)
            outs.append(logits)
        runs.append(torch.cat(outs, 1).float())
    n = cfg.num_layers
    assert ops.LAUNCHES["flash_attention"] == n
    assert ops.LAUNCHES["swiglu"] == 5 * n
    assert ops.LAUNCHES["rmsnorm"] == 5 * (2 * n + 1)
    tol = 1e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(runs[0], runs[1], rtol=tol, atol=tol)


# (B, H, S, dk, dv, chunk): the reference's sweep, ragged S and odd
# widths, Hymba's head (dk 16, dv 64) and xLSTM's (384 / 384); for the
# chunked route (bf16) also S under one chunk, dk and dv at one 64-wide
# tile and several and off the tile, chunks of 64 and 128, and dk 512
SCAN_CASES = [(2, 3, 32, 16, 8, 8), (2, 3, 40, 16, 8, 16),
              (2, 3, 16, 16, 8, 16), (1, 2, 300, 20, 70, 64),
              (2, 5, 700, 16, 64, 256), (1, 2, 600, 384, 384, 256),
              (1, 1, 5, 1, 1, 256), (1, 2, 129, 512, 65, 128),
              (2, 2, 40, 64, 64, 256), (1, 3, 200, 64, 64, 64),
              (1, 2, 300, 128, 192, 128), (1, 2, 130, 72, 320, 64),
              (1, 2, 129, 512, 64, 128)]


def scan_inputs(B, H, S, dk, dv, normalize, dtype, device, seed=0,
                init=False):
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=device)
    q, k = rn(B, H, S, dk).to(dtype), (rn(B, H, S, dk) * dk ** -0.5).to(dtype)
    v = rn(B, H, S, dv).to(dtype)
    log_f = torch.nn.functional.logsigmoid(rn(B, H, S) + 2)
    log_i = rn(B, H, S) * 0.5 if normalize else None
    state = None
    if init:
        state = {"S": rn(B, H, dk, dv) * 0.5, "n": rn(B, H, dk) * 0.5,
                 "m": rn(B, H) * 0.2 if normalize else torch.zeros(
                     B, H, device=device)}
    return q, k, v, log_f, log_i, state


def assert_scan_close(got, want):
    for a, b in zip((got[0], *got[1].values()), (want[0], *want[1].values())):
        assert a.dtype == b.dtype and a.shape == b.shape
        rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-4
        atol = 2e-5 * max(1.0, float(b.float().abs().max()))
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_mlstm_scan_kernel_matches_plain(cuda, case, dtype, normalize, init):
    """Output and final state (S, n, m) against the plain version, from
    zeros and from a given initial state; one launch, repeatable. bf16
    takes the chunked route wherever dk and dv are multiples of 8 and
    the chunk of 64 (Hymba's and xLSTM's heads among them), f32 always
    the one-block kernel."""
    B, H, S, dk, dv, chunk = case
    q, k, v, f, i, st = scan_inputs(B, H, S, dk, dv, normalize, dtype, cuda,
                                    init=init)
    chunked = (dtype == torch.bfloat16 and dk % 8 == 0 and dv % 8 == 0
               and chunk % 64 == 0)
    kind = "wgmma" if chunked else "simple"
    assert kmlstm.route(dtype, dk, dv, chunk) == kind
    before, routes = ops.LAUNCHES["mlstm_scan"], dict(kmlstm.ROUTES)
    got = ops.mlstm_scan(q, k, v, f, i, chunk=chunk, normalize=normalize,
                         initial_state=st)
    assert ops.LAUNCHES["mlstm_scan"] == before + 1
    assert kmlstm.ROUTES == {**routes, kind: routes[kind] + 1}
    want = ref.mlstm_scan_state_ref(q, k, v, f, i, chunk=chunk,
                                    normalize=normalize, initial_state=st)
    assert_scan_close(got, want)
    again = ops.mlstm_scan(q, k, v, f, i, chunk=chunk, normalize=normalize,
                           initial_state=st)
    assert torch.equal(again[0], got[0])


@pytest.mark.parametrize("k_view", [False, True], ids=["k_copy", "k_view"])
@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_scan_bshd_reads_views_in_place(cuda, dtype, normalize, k_view):
    """The blocks' (B, S, H, d) tensors go in as transposed views, q a
    slice of a wider projection as Hymba's C is (and k too, as Hymba's B
    is, with ``k_view``); the output comes back (B, S, H, dv)
    contiguous. In bf16 the views take the chunked route (TMA maps read
    them in place)."""
    B, S, H, dk, dv = 2, 300, 5, 16, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    bc = torch.randn(B, S, 2, H, dk, generator=g, device=cuda).to(dtype)
    q, k = bc[:, :, 1], bc[:, :, 0] if k_view else bc[:, :, 0] * 0.25
    t = lambda x: x.transpose(1, 2)
    kind = "wgmma" if dtype == torch.bfloat16 else "simple"
    assert kmlstm.route(dtype, dk, dv, 128, all(
        tma.tma_describable(t(x)) for x in (q, k))) == kind
    v = torch.randn(B, S, H, dv, generator=g, device=cuda).to(dtype)
    f = torch.nn.functional.logsigmoid(
        torch.randn(B, S, H, generator=g, device=cuda) + 2)
    i = torch.randn(B, S, H, generator=g, device=cuda) if normalize else None
    routes = dict(kmlstm.ROUTES)
    out, state = ops.mlstm_scan_bshd(q, k, v, f, i, chunk=128,
                                     normalize=normalize)
    assert kmlstm.ROUTES == {**routes, kind: routes[kind] + 1}
    assert out.is_contiguous() and out.shape == (B, S, H, dv)
    want = ops.PLAIN.mlstm_scan_bshd(q, k, v, f, i, chunk=128,
                                     normalize=normalize)
    assert_scan_close((out, state), want)


def test_mlstm_scan_refuses_bad_inputs(cuda):
    q = torch.ones(1, 2, 8, 16, device=cuda)
    v = torch.ones(1, 2, 8, 4, device=cuda)
    f = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kmlstm.mlstm_scan(q.half(), q.half(), v.half(), f)
    with pytest.raises(ValueError, match="float32 gates"):
        kmlstm.mlstm_scan(q, q, v, f.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dk <= 512"):
        big = torch.ones(1, 2, 8, 520, device=cuda)
        kmlstm.mlstm_scan(big, big, v, f)
    with pytest.raises(ValueError, match="chunk <= 256"):
        kmlstm.mlstm_scan(q, q, v, f, chunk=512)
    with pytest.raises(ValueError, match=r"\(B, H, S, dk\)"):
        kmlstm.mlstm_scan(q, q[:, :1], v, f)
    with pytest.raises(ValueError, match="initial_state"):
        kmlstm.mlstm_scan(q, q, v, f, initial_state={
            "S": torch.zeros(1, 2, 4, 16, device=cuda),
            "n": torch.zeros(1, 2, 16, device=cuda),
            "m": torch.zeros(1, 2, device=cuda)})
    with pytest.raises(ValueError, match="one CUDA device"):
        kmlstm.mlstm_scan(q, q, v, f.cpu())


@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
def test_mlstm_scan_routes_agree(cuda, normalize):
    """In bf16 the chunked route holds to the plain version, and operands
    it does not take (dk 20, a view TMA cannot describe) go to the
    one-block kernel, read in place, which holds to it too; the route
    each call took is the one ``route()`` gives."""
    q, k, v, f, i, st = scan_inputs(1, 3, 300, 64, 128, normalize,
                                    torch.bfloat16, cuda, seed=5, init=True)
    off = torch.empty(1, 3, 300, 72, dtype=torch.bfloat16,
                      device=cuda)[..., 4:68]
    off.copy_(q)
    q20 = q[..., :20].contiguous()
    assert not tma.tma_describable(off)
    assert kmlstm.route(torch.bfloat16, 20, 128, 128) == "simple"
    for qq, kk, state, kind in ((q, k, st, "wgmma"), (off, k, None, "simple"),
                                (q20, q20, None, "simple")):
        assert kmlstm.route(torch.bfloat16, qq.shape[3], 128, 128, all(
            tma.tma_describable(x) for x in (qq, kk, v))) == kind
        routes = dict(kmlstm.ROUTES)
        got = kmlstm.mlstm_scan(qq, kk, v, f, i, chunk=128,
                                normalize=normalize, initial_state=state)
        assert kmlstm.ROUTES == {**routes, kind: routes[kind] + 1}
        assert_scan_close(got, ref.mlstm_scan_state_ref(
            qq, kk, v, f, i, chunk=128, normalize=normalize,
            initial_state=state))


def cancel_inputs(part, device, seed=0):
    """bf16 inputs on which the output needs all three bf16 terms of an
    f32 operand (``chip_smoke.scan_cancel_inputs``): ``"P"``, normalized,
    one chunk of 256, keys in pairs with equal k, opposite v and weights
    2**-6 apart, so P V is a difference of near-equal terms; ``"S"``, SSD
    over two chunks from an initial state with rows in pairs, S_2d+1 =
    -(1 + 2**-6) S_2d, q equal in each pair and v 2**-20 small. One bf16
    term of either misses by about 2**-3 of the output. Returns (q, k,
    v, log f, log i, state, chunk, normalize)."""
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=device)
    bf, d = torch.bfloat16, 2.0 ** -6
    if part == "P":
        B, H, S, dk, dv = 1, 4, 256, 64, 128
        q = rn(B, H, S, dk).to(bf)
        k = (rn(B, H, S // 2, dk) * dk ** -0.5).to(bf).repeat_interleave(2, 2)
        v = rn(B, H, S // 2, dv).to(bf).repeat_interleave(2, 2)
        v[:, :, 1::2] = -v[:, :, 1::2]
        f = torch.nn.functional.logsigmoid(rn(B, H, S) + 4)
        i = (rn(B, H, S // 2) * 0.5).repeat_interleave(2, 2)
        i[..., 1::2] += f[..., 1::2] + d
        return q, k, v, f, i, None, 256, True
    B, H, S, dk, dv = 1, 4, 300, 128, 128
    q = rn(B, H, S, dk // 2).to(bf).repeat_interleave(2, 3)
    k = (rn(B, H, S, dk) * dk ** -0.5).to(bf)
    v = (rn(B, H, S, dv) * 2.0 ** -20).to(bf)
    f = torch.nn.functional.logsigmoid(rn(B, H, S) + 4)
    S0 = rn(B, H, dk // 2, dv).repeat_interleave(2, 2)
    S0[:, :, 1::2] *= -(1 + d)
    state = {"S": S0, "n": torch.zeros(B, H, dk, device=device),
             "m": torch.zeros(B, H, device=device)}
    return q, k, v, f, None, state, 256, False


@pytest.mark.parametrize("part", ["P", "S"])
def test_mlstm_scan_keeps_all_three_bf16_terms(cuda, part):
    """On inputs where P V (``"P"``) or q . S_prev (``"S"``) is a
    difference of near-equal terms the chunked route still holds to the
    plain version: a kernel that multiplied one bf16 term of P or of the
    entering state would miss by far (``tests/test_torch_ssm.py`` shows
    it on the CPU mirror)."""
    q, k, v, f, i, st, chunk, nz = cancel_inputs(part, cuda)
    routes = dict(kmlstm.ROUTES)
    got = ops.mlstm_scan(q, k, v, f, i, chunk=chunk, normalize=nz,
                         initial_state=st)
    assert kmlstm.ROUTES == {**routes, "wgmma": routes["wgmma"] + 1}
    assert_scan_close(got, ref.mlstm_scan_state_ref(
        q, k, v, f, i, chunk=chunk, normalize=nz, initial_state=st))


def test_mlstm_scan_long_sequence_memory(cuda):
    """S of 16,384 at xLSTM-125M's heads in bf16: held to the plain
    version, and the call takes no more memory above its inputs than its
    output, its final state and the stated workspace (one f32 state a
    chunk), plus the allocator's rounding."""
    B, H, S, dk, dv = 1, 2, 16384, 384, 384
    q, k, v, f, i, _ = scan_inputs(B, H, S, dk, dv, True, torch.bfloat16,
                                   cuda, seed=9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = ops.mlstm_scan(q, k, v, f, i, chunk=256, normalize=True)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= (got[0].nbytes + sum(t.nbytes for t in got[1].values())
                     + 4 * kmlstm.workspace(B, H, S, dk, dv, 256) + 2 ** 21)
    assert_scan_close(got, ref.mlstm_scan_state_ref(q, k, v, f, i, chunk=256,
                                                    normalize=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["xlstm-125m", "hymba-1.5b"])
def test_reduced_ssm_serve_kernels_vs_plain(cuda, arch, dtype):
    """Reduced xLSTM (4 layers: a list stack with an sLSTM) and Hymba (its
    window 64 under 80 prompt tokens) on the card: prefill and 4
    teacher-forced decode steps through the kernels against
    ``kernels=ops.PLAIN``, with exact launch counts. Logits: f32 within
    1e-4; bf16 within 5e-2, as the dense model's."""
    layers = 4 if arch == "xlstm-125m" else 2
    cfg = dataclasses.replace(get_config(arch).reduced(num_layers=layers),
                              use_kernels=True, dtype=dtype)
    params = T.init_params(cfg, torch.Generator(cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (3, 80), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    runs = []
    for kernels in (None, ops.PLAIN):
        logits, cache, _ = T.prefill(cfg, params, toks, kernels=kernels)
        cache = T.grow_cache(cfg, cache, 4)
        outs = [logits]
        for step in range(4):
            logits, cache = T.decode_step(cfg, params, toks[:, step:step + 1],
                                          cache, 80 + step, kernels=kernels)
            outs.append(logits)
        runs.append(torch.cat(outs, 1).float())
    n = cfg.num_layers
    counts = {k: c for k, c in ops.LAUNCHES.items() if c}
    if arch == "hymba-1.5b":
        assert counts == {"mlstm_scan": n, "flash_attention": n,
                          "swiglu": 5 * n, "rmsnorm": 5 * (2 * n + 1)}
    else:
        assert counts == {"mlstm_scan": 3, "rmsnorm": 5}
    tol = 1e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(runs[0], runs[1], rtol=tol, atol=tol)
