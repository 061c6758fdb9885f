"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without CUDA; the
file imports no JAX, so it runs on a machine that has only PyTorch:
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: the kernel sums in f32 in another order than the plain
version (per-thread, then per-block partials), so f32 outputs agree to
rtol 1e-5 with an absolute floor scaled by the sum's size; bf16 agg
may differ by one bf16 ulp where the f32 sums straddle a rounding
boundary.
"""
import pytest
import torch

from repro_torch.kernels import fedavg_agg, ops, ref

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
