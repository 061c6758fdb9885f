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
ulp. A compressed round chunk through the
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
that error (seen: 3e-5 at D = 960 in bf16). ``flash_attention``: f32
rtol = atol = 2e-5, bf16 2e-2 (the reference's own kernel tolerances,
tests/test_kernels.py; the bf16 kernel also rounds the probabilities to
bf16 for the P·V product).
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
from repro_torch.kernels import compression as kcomp
from repro_torch.kernels import fedavg_agg, mkp_utility, ops, ref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import rmsnorm as krms
from repro_torch.kernels import segmented_topk
from repro_torch.kernels import swiglu as kswiglu
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
    the kernel once per leaf (8) and agrees with the plain round."""
    batches, w, mask, params = cifar_round_inputs(cuda)
    loss = lambda p, b: cnn.loss_fn(cnn.CIFAR_CNN, p, b)
    before = dict(ops.LAUNCHES)
    pk, ik = make_fl_round(loss, local_lr=0.1, use_agg_kernel=True)(
        params, batches, w, mask)
    counts = {n: ops.LAUNCHES[n] - before[n] for n in before}
    pp, ip = make_fl_round(loss, local_lr=0.1, use_agg_kernel=True,
                           kernels=ops.PLAIN)(params, batches, w, mask)
    torch.cuda.synchronize()
    assert {n: c for n, c in counts.items() if c} == {"fedavg_agg": 8}
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
    assert torch.equal(got[0], exp[0])
    fin = torch.isfinite(exp[0])
    assert torch.equal(got[1][fin], exp[1][fin])


def topk_input(S, C, kind, cuda):
    g = torch.Generator(device=cuda).manual_seed(S * 31 + C)
    if kind == "normal":
        return torch.randn(S, C, generator=g, device=cuda)
    if kind == "ties":          # few distinct values: ties at every boundary
        return torch.randint(0, 5, (S, C), generator=g,
                             device=cuda).float() / 4
    x = torch.randn(S, C, generator=g, device=cuda)  # -inf padded rows
    x[:, C // 3:] = float("-inf")
    x[-1] = float("-inf")
    if C > 2:
        x[0, 1], x[0, 2] = -0.0, 0.0
    return x


@pytest.mark.parametrize("kind", ["normal", "ties", "padded"])
@pytest.mark.parametrize("S,C,k", [(3, 1000, 7), (8, 131072, 1),
                                   (8, 131072, 32), (8, 131072, 4096),
                                   (2, 131072, 131072), (5, 9000, 4097),
                                   (1, 1, 1), (4, 77, 100)])
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
    x = torch.randn(K, P, generator=g, device=cuda)
    if kind == "zeros":
        x[:, : max(1, P // 2)] = 0.0
        if P >= 4:
            amax = x[0].abs().max()
            x[0, -2], x[0, -1] = amax, -amax
    return x


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("K,P,k", [(1, 7, 1), (1, 7, 7), (13, 4097, 1),
                                   (13, 4097, 4097), (3, 100_003, 777),
                                   (13, MAIN_P, MAIN_TOPK)])
def test_topk_sparsify_matches_plain(cuda, K, P, k, kind):
    x = codec_input(K, P, kind, cuda)
    before = ops.LAUNCHES["topk_sparsify"]
    got = ops.topk_sparsify(x, k)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_sparsify"] == before + 1
    exp = ref.topk_sparsify_ref(x, k)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


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
                                   (7, 960), (8192, 960), (2, 4100)])
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


# (B, H, G, Sq, Sk, hd, causal, window): the sweep of tests/test_kernels.py,
# then the serve shape's head size at ragged lengths, the CUDA-core
# kernel's head sizes (48, 256) and the tensor-core kernel's largest (128)
FA_CASES = [(1, 2, 2, 32, 32, 16, True, 0), (2, 4, 2, 64, 64, 32, True, 0),
            (1, 8, 1, 48, 48, 64, True, 0), (1, 2, 1, 64, 64, 16, True, 8),
            (1, 2, 1, 64, 64, 16, True, 16), (2, 4, 2, 1, 128, 32, True, 0),
            (1, 2, 2, 32, 32, 16, False, 0), (1, 2, 2, 40, 40, 16, True, 0),
            (2, 15, 5, 300, 300, 64, True, 0),
            (1, 15, 5, 200, 333, 64, True, 100),
            (1, 4, 2, 70, 70, 64, False, 30), (1, 4, 4, 1, 333, 64, True, 64),
            (1, 2, 1, 50, 50, 48, True, 0), (1, 2, 2, 33, 65, 256, True, 0),
            (1, 4, 2, 129, 129, 128, True, 0)]


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
def test_flash_attention_bshd_reads_views_in_place(cuda, dtype):
    """The models' (B, S, H, hd) tensors go in as transposed views; the
    output comes back (B, S, H, hd) contiguous, no copy made."""
    q = randn((2, 100, 15, 64), dtype, 9, cuda)
    k = randn((2, 100, 5, 64), dtype, 10, cuda)
    v = randn((2, 100, 5, 64), dtype, 11, cuda)
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
