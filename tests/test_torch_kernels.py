"""Port parity: the plain PyTorch ``fedavg_agg_quality`` against the JAX
package's oracle (``repro.kernels.ref``) and its Pallas kernel in
interpret mode, over ragged K x P in f32 and bf16; and the dispatching
wrapper's CPU behaviour. The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: both sides sum in f32 but in different orders, so the f32
outputs agree to a few ulps of the largest partial sum (rtol 1e-5,
atol 1e-5 on unit-normal data). A bf16 agg is the f32 agg rounded to
bf16, and an ulp of difference in f32 can move that rounding by one
bf16 ulp (rtol 2**-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fedavg_agg import fedavg_agg_quality as pallas_agg_quality
from repro_torch.kernels import fedavg_agg, ops, ref

SHAPES = [(1, 1), (1, 64), (3, 130), (4, 128), (8, 50), (13, 1000),
          (13, 4097), (64, 255)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def inputs(K, P, dtype, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((K, P)).astype(np.float32)
    w = rng.random(K).astype(np.float32)
    w /= w.sum()
    tdt, jdt = DTYPES[dtype]
    ut = torch.as_tensor(u).to(tdt)
    # both sides see the same bf16 values
    uj = jnp.asarray(ut.to(torch.float32).numpy()).astype(jdt)
    return ut, torch.as_tensor(w), uj, jnp.asarray(w)


def assert_outputs_close(port, refs, dtype):
    agg_rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    agg, dots, sq, asq = port
    r_agg, r_dots, r_sq, r_asq = refs
    assert agg.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(agg.to(torch.float32).numpy(),
                               np.asarray(r_agg, np.float32),
                               rtol=agg_rtol, atol=1e-5)
    for a, b in ((dots, r_dots), (sq, r_sq), (asq, r_asq)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,P", SHAPES)
def test_plain_matches_jax_oracle(K, P, dtype):
    ut, wt, uj, wj = inputs(K, P, dtype)
    assert_outputs_close(ref.fedavg_agg_quality_ref(ut, wt),
                         jref.fedavg_agg_quality_ref(uj, wj), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,P", [(1, 64), (3, 130), (13, 1000), (8, 50)])
def test_plain_matches_pallas_interpret(K, P, dtype):
    ut, wt, uj, wj = inputs(K, P, dtype, seed=1)
    assert_outputs_close(
        ref.fedavg_agg_quality_ref(ut, wt),
        pallas_agg_quality(uj, wj, block_p=64, interpret=True), dtype)


def test_dots_use_f32_agg_not_cast_agg():
    """dots is ⟨u_k, agg_f32⟩: with bf16 updates it differs from the dot
    against the bf16-rounded agg."""
    ut, wt, _, _ = inputs(6, 333, "bfloat16", seed=2)
    agg, dots, _, asq = ref.fedavg_agg_quality_ref(ut, wt)
    u = ut.to(torch.float32)
    agg32 = wt @ u
    torch.testing.assert_close(dots, u @ agg32, rtol=0, atol=0)
    torch.testing.assert_close(asq, agg32 @ agg32, rtol=0, atol=0)
    assert not torch.equal(agg.to(torch.float32), agg32)


def test_ops_cpu_takes_plain_path_and_counts_nothing():
    ut, wt, _, _ = inputs(5, 200, "float32")
    before = ops.LAUNCHES["fedavg_agg_quality"]
    out = ops.fedavg_agg_quality(ut, wt)
    for a, b in zip(out, ref.fedavg_agg_quality_ref(ut, wt)):
        assert torch.equal(a, b)
    assert ops.LAUNCHES["fedavg_agg_quality"] == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel entry never falls back to the plain version."""
    ut, wt, _, _ = inputs(2, 10, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fedavg_agg.fedavg_agg_quality(ut, wt)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(fedavg_agg, "BUILD_DIR", tmp_path / "build")
    fedavg_agg.library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fedavg_agg.library()
    fedavg_agg.library.cache_clear()


def test_grid_depends_on_p_only():
    assert fedavg_agg.num_blocks(1) == 1
    assert fedavg_agg.num_blocks(256) == 1
    assert fedavg_agg.num_blocks(257) == 2
    assert fedavg_agg.num_blocks(1_070_794) == fedavg_agg.MAX_BLOCKS
