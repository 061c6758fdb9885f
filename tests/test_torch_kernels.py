"""Port parity: the plain PyTorch versions of the port's kernels against
the JAX package's oracles (``repro.kernels.ref``) and its Pallas kernels
in interpret mode; and the dispatching wrappers' CPU behaviour. The
CUDA kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

- ``fedavg_agg_quality`` and ``fedavg_agg`` over ragged K x P in f32
  and bf16;
- ``segmented_topk`` over the shape sweep of tests/test_scale_plane.py
  and at small C, with lowest-lane ties and -inf padding: exact (values
  and lanes of every finite entry); the CUDA wrapper's chunks a row and
  scratch size, against the source's layout;
- ``mkp_utility`` over ragged n x m; ``mkp_greedy``'s CPU route (its
  plain version, the JAX comparison in tests/test_torch_selection_plane.py);
- ``rmsnorm``, ``swiglu`` and ``flash_attention`` over the sweeps of
  tests/test_kernels.py (causal MHA / GQA / MQA, sliding windows, Sq=1
  against a long KV, non-causal, ragged S; ragged M, D, F).

Tolerances: both sides sum in f32 but in different orders, so the f32
outputs agree to a few ulps of the largest partial sum (rtol 1e-5,
atol 1e-5 on unit-normal data). A bf16 agg is the f32 agg rounded to
bf16, and an ulp of difference in f32 can move that rounding by one
bf16 ulp (rtol 2**-7). ``mkp_utility``: the JAX oracle's penalty is a
dot whose order XLA chooses, the port's a left-to-right column sum, so
utilities agree to a few f32 ulps (rtol 1e-6); which items are
feasible (finite) is exact. The serve path's ops use the reference's own
kernel tolerances (tests/test_kernels.py): rtol = atol = 2e-5 in f32,
where only summation order, ``rsqrt`` and ``exp`` rounding differ, and
2e-2 in bf16, where the f32 results straddle bf16 roundings (one bf16
ulp is 2**-8 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fedavg_agg import fedavg_agg as pallas_agg
from repro.kernels.fedavg_agg import fedavg_agg_quality as pallas_agg_quality
from repro_torch.kernels import (build, compression, fedavg_agg,
                                 mkp_utility, ops, ref, segmented_topk)

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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,P", SHAPES + [(100, 257), (130, 10)])
def test_fedavg_agg_plain_matches_oracle_and_pallas(K, P, dtype):
    ut, wt, uj, wj = inputs(K, P, dtype, seed=3)
    got = ref.fedavg_agg_ref(ut, wt)
    assert got.dtype == DTYPES[dtype][0] and got.shape == (P,)
    agg_rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    for oracle in (jref.fedavg_agg_ref(uj, wj),
                   pallas_agg(uj, wj, block_p=64, interpret=True)):
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(oracle, np.float32),
                                   rtol=agg_rtol, atol=1e-5)
    # the aggregate of the fused pass is the same sum
    torch.testing.assert_close(got, ref.fedavg_agg_quality_ref(ut, wt)[0],
                               rtol=0, atol=0)


def test_fedavg_agg_ops_cpu_take_plain_path_and_count_nothing():
    ut, wt, _, _ = inputs(4, 96, "float32", seed=4)
    before = ops.LAUNCHES["fedavg_agg"]
    assert torch.equal(ops.fedavg_agg(ut, wt), ref.fedavg_agg_ref(ut, wt))
    tree = {"a.w": ut.reshape(4, 8, 12), "a.b": ut[:, :5]}
    for fn in (ops.fedavg_agg_tree, ops.PLAIN.fedavg_agg_tree):
        out = fn(tree, wt)
        assert out["a.w"].shape == (8, 12) and out["a.b"].shape == (5,)
        assert torch.equal(out["a.w"].reshape(-1), ref.fedavg_agg_ref(ut, wt))
        assert torch.equal(out["a.b"], ref.fedavg_agg_ref(ut[:, :5], wt))
    assert ops.LAUNCHES["fedavg_agg"] == before
    assert ops.PLAIN.fedavg_agg is ref.fedavg_agg_ref


def test_fedavg_agg_kernel_refuses_cpu_tensors():
    ut, wt, _, _ = inputs(2, 10, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fedavg_agg.fedavg_agg(ut, wt)
    with pytest.raises(ValueError, match="CUDA"):
        fedavg_agg.fedavg_agg_tree({"x": ut}, wt)


@pytest.mark.parametrize("dtype,P,vec", [
    (torch.float32, 1_070_794, 2), (torch.float32, 1_048_576, 4),
    (torch.float32, 10, 2), (torch.float32, 255, 1),
    (torch.bfloat16, 1_070_794, 2), (torch.bfloat16, 864, 8),
    (torch.bfloat16, 12, 4), (torch.bfloat16, 7, 1)])
def test_fedavg_agg_vector_width_divides_rows(dtype, P, vec):
    """Each thread of the aggregate kernel loads the widest vector (16
    bytes at most) that divides P and the base, so no load straddles a
    client's row."""
    u = torch.empty(3, P, dtype=dtype)
    assert fedavg_agg.vector_width(u) == vec


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library()
    build.library.cache_clear()


def test_build_compiles_every_source_into_one_library():
    names = [p.name for p in build.sources()]
    assert names == sorted(["fedavg_agg.cu", "fedavg_agg_quality.cu",
                            "flash_attention.cu",
                            "mkp_utility.cu", "mlstm_scan.cu", "quantize_i8.cu",
                            "rmsnorm.cu", "segmented_topk.cu", "swiglu.cu"])
    assert build._lib_path().parent == build.BUILD_DIR


def test_grid_depends_on_p_only():
    assert fedavg_agg.num_blocks(1) == 1
    assert fedavg_agg.num_blocks(256) == 1
    assert fedavg_agg.num_blocks(257) == 2
    assert fedavg_agg.num_blocks(1_070_794) == fedavg_agg.MAX_BLOCKS


def test_build_names_the_library_by_its_headers_too(monkeypatch, tmp_path):
    """An edit to a header (``csrc/*.cuh``) the sources include names a
    new library, so a stale one is never loaded; so does a source's."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build.headers()] == ["hopper.cuh"]
    first = build._lib_path()
    assert build._lib_path() == first
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    second = build._lib_path()
    assert second != first and second.parent == build.BUILD_DIR
    source = csrc / "swiglu.cu"
    source.write_text(source.read_text() + "\n// an edit\n")
    assert build._lib_path() not in (first, second)


@pytest.mark.parametrize("leaves,want", [
    # the CIFAR_CNN leaves (f32, 16-byte vectors where P allows): one table
    ([(torch.float32, 864, 4), (torch.float32, 32, 4),
      (torch.float32, 18_432, 4), (torch.float32, 64, 4),
      (torch.float32, 1_048_576, 4), (torch.float32, 256, 4),
      (torch.float32, 2_560, 4), (torch.float32, 10, 2)],
     [(torch.float32, list(range(8)),
       [0, 1, 2, 20, 21, 1045, 1046, 1049, 1050], 1050)]),
    # one element, a partial chunk, and bf16's 8-wide vectors
    ([(torch.bfloat16, 1, 1), (torch.bfloat16, 2049, 1),
      (torch.bfloat16, 4096, 8)],
     [(torch.bfloat16, [0, 1, 2], [0, 1, 10, 12], 12)]),
    # two dtypes: a table each, in the order of their first leaf
    ([(torch.bfloat16, 8, 8), (torch.float32, 8, 4), (torch.bfloat16, 16, 8)],
     [(torch.bfloat16, [0, 2], [0, 1, 2], 2),
      (torch.float32, [1], [0, 1], 1)]),
    # a grid capped at AGG_BLOCKS chunks (the blocks walk the rest)
    ([(torch.float32, 4 * 256 * 3000, 4)],
     [(torch.float32, [0], [0, 3000], 2048)])])
def test_fedavg_leaf_tables_offsets_and_chunks(leaves, want):
    """Each leaf starts on a chunk of 256 column groups (so a block's
    chunk lies in one leaf); leaves of one dtype share a table."""
    got = fedavg_agg.leaf_tables(leaves)
    assert [(t["dtype"], t["leaves"], t["chunk0"], t["blocks"])
            for t in got] == want


def test_fedavg_leaf_tables_split_past_the_maximum_and_refuse_dtypes():
    n = 2 * fedavg_agg.MAX_LEAVES + 5
    tables = fedavg_agg.leaf_tables([(torch.float32, 300, 4)] * n)
    assert [len(t["leaves"]) for t in tables] == [fedavg_agg.MAX_LEAVES,
                                                 fedavg_agg.MAX_LEAVES, 5]
    assert sum((t["leaves"] for t in tables), []) == list(range(n))
    for t in tables:
        assert t["chunk0"] == list(range(len(t["leaves"]) + 1))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fedavg_agg.leaf_tables([(torch.float32, 8, 4), (torch.float16, 8, 8)])
    assert fedavg_agg.leaf_tables([]) == []


@pytest.mark.parametrize("dtype,M,D,F,aligned,want", [
    # the four serve shapes: prefill takes wgmma, a decode step split-K
    (torch.bfloat16, 8192, 960, 2560, True, "wgmma"),
    (torch.bfloat16, 8, 960, 2560, True, "splitk"),
    (torch.bfloat16, 8192, 1600, 5504, True, "wgmma"),
    (torch.bfloat16, 4, 1600, 5504, True, "splitk"),
    # the edges of the decode route: its rows and its D
    (torch.bfloat16, 8, 1600, 5504, True, "splitk"),
    (torch.bfloat16, 9, 960, 2560, True, "wgmma"),
    (torch.bfloat16, 1, 2048, 64, True, "splitk"),
    (torch.bfloat16, 1, 2056, 64, True, "wgmma"),
    # ragged shapes TMA describes: any M, D and F multiples of 8
    (torch.bfloat16, 1000, 200, 72, True, "wgmma"),
    (torch.bfloat16, 3, 8, 8, True, "splitk"),
    # what TMA cannot describe takes mma.sync
    (torch.bfloat16, 8192, 962, 2560, True, "mma"),
    (torch.bfloat16, 8, 960, 2564, True, "mma"),
    (torch.bfloat16, 8192, 960, 2560, False, "mma"),
    (torch.bfloat16, 8, 960, 2560, False, "mma"),
    # f32 takes the CUDA-core kernel, whatever its shape
    (torch.float32, 8192, 960, 2560, True, "simple"),
    (torch.float32, 8, 960, 2560, True, "simple"),
    (torch.float32, 5, 50, 37, False, "simple")])
def test_swiglu_route(dtype, M, D, F, aligned, want):
    from repro_torch.kernels import swiglu as ks
    assert ks.route(dtype, M, D, F, aligned) == want
    kinds = ks._routes(dtype, M, D, F, aligned)
    assert kinds[0] == want and len(set(kinds)) == len(kinds)


@pytest.mark.parametrize("D,F,sms,want", [
    (960, 2560, 132, (6, 160)), (1600, 5504, 132, (7, 256)),
    (2048, 64, 132, (8, 256)), (17, 8, 132, (1, 32)), (8, 8, 132, (1, 32)),
    (960, 2560, 16, (4, 256)), (1600, 5504, 1, (7, 256)),
    (960, 64, 132, (8, 128)), (100, 64, 132, (4, 32))])
def test_swiglu_decode_split(D, F, sms, want):
    """Splits of at most 256 rows of D (a multiple of the kernel's 32-row
    TMA box), at most 8 (a portable cluster), as many as keep the blocks
    within two an SM."""
    from repro_torch.kernels import swiglu as ks
    splits, kc = ks.decode_split(D, F, sms)
    assert (splits, kc) == want
    assert kc % ks.DECODE_CHUNK == 0 and kc <= ks.MAX_KC
    assert 1 <= splits <= ks.MAX_SPLITS
    assert kc * (splits - 1) < D <= kc * splits
    tiles = -(-F // 64)
    assert splits * tiles <= max(2 * sms, tiles * -(-D // ks.MAX_KC))


# ---------------------------------------------------------------------------
# segmented_topk
# ---------------------------------------------------------------------------

def assert_topk_equal(port, vals, lanes):
    """Equal values everywhere and equal lanes at every finite entry (a
    -inf slot's lane is not part of the contract)."""
    pv, pl = port
    vals, lanes = np.asarray(vals), np.asarray(lanes)
    assert pv.dtype == torch.float32 and pl.dtype == torch.int32
    np.testing.assert_array_equal(pv.numpy(), vals)
    fin = np.isfinite(vals)
    np.testing.assert_array_equal(pl.numpy()[fin], lanes[fin])


@pytest.mark.parametrize("S,C,k", [(1, 8, 3), (4, 64, 8), (7, 129, 16),
                                   (3, 32, 32), (2, 16, 40), (3, 1000, 7),
                                   (2, 5, 1)])
def test_segmented_topk_plain_matches_jax(S, C, k):
    x = np.random.default_rng(S * C + k).normal(size=(S, C)).astype(np.float32)
    x[0, ::3] = -np.inf                            # -inf padding in row 0
    port = ref.segmented_topk_ref(torch.as_tensor(x), k)
    assert_topk_equal(port, *jref.segmented_topk_ref(jnp.asarray(x), k))
    if C <= 129:                                   # interpret runs k passes
        assert_topk_equal(port, *jops.segmented_topk(jnp.asarray(x), k,
                                                     interpret=True))


def test_segmented_topk_ties_and_exhaustion():
    x = np.full((4, 12), -np.inf, np.float32)
    x[0, [3, 7, 11]] = 5.0                         # three-way tie
    x[0, [1, 5]] = 2.0
    x[1, :] = 1.0                                  # full-row tie
    x[2, 2] = 1.0                                  # fewer finite than k
    x[3, :] = np.repeat(np.float32([3.0, 1.0, 2.0]), 4)
    vals, lanes = ref.segmented_topk_ref(torch.as_tensor(x), 5)
    np.testing.assert_array_equal(lanes[0].numpy(), [3, 7, 11, 1, 5])
    np.testing.assert_array_equal(lanes[1].numpy(), [0, 1, 2, 3, 4])
    assert vals[2, 0] == 1.0 and lanes[2, 0] == 2
    assert torch.isinf(vals[2, 1:]).all()
    np.testing.assert_array_equal(lanes[3].numpy(), [0, 1, 2, 3, 8])
    assert_topk_equal((vals, lanes), *jops.segmented_topk(
        jnp.asarray(x), 5, interpret=True))


def test_segmented_topk_negative_zero_ties_like_pallas():
    """-0.0 and +0.0 tie, as the Pallas kernel's == compare has them
    (``lax.top_k``, the JAX oracle, orders -0.0 below +0.0)."""
    x = np.zeros((1, 8), np.float32)
    x[0, [1, 4]] = -0.0
    x[0, 6] = 1.0
    port = ref.segmented_topk_ref(torch.as_tensor(x), 5)
    np.testing.assert_array_equal(port[1][0].numpy(), [6, 0, 1, 2, 3])
    assert_topk_equal(port, *jops.segmented_topk(jnp.asarray(x), 5,
                                                 interpret=True))


@pytest.mark.parametrize("S,C,k", [(4, 37, 10), (3, 200, 200), (5, 64, 17)])
def test_topk_plain_matches_jitted_oracles_on_nonfinite_rows(S, C, k):
    """NaN, +inf and -inf in every row (and a row of -inf with two NaN):
    both plain top-k versions equal ``repro.kernels.ref``'s jitted
    ``lax.top_k`` oracles, values and indices in every slot (NaN first,
    then +inf, ties to the lowest lane). The Pallas kernels are left
    out: on a NaN row they emit lane C by design."""
    rng = np.random.default_rng(S * C + k)
    x = rng.standard_normal((S, C)).astype(np.float32)
    for r in range(S):
        for val, n in ((np.nan, 2 + r), (np.inf, 1 + r), (-np.inf, 3)):
            x[r, rng.choice(C, n, replace=False)] = val
    x[-1, :] = -np.inf
    x[-1, [3, 9]] = np.nan
    for port, oracle in ((ref.segmented_topk_ref, jref.segmented_topk_ref),
                         (ref.topk_sparsify_ref, jref.topk_sparsify_ref)):
        got = port(torch.as_tensor(x), k)
        want = jax.jit(oracle, static_argnums=1)(jnp.asarray(x), k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_segmented_topk_ops_cpu_counts_nothing():
    x = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    before = ops.LAUNCHES["segmented_topk"]
    for a, b in zip(ops.segmented_topk(x, 9), ref.segmented_topk_ref(x, 9)):
        assert torch.equal(a, b)
    assert ops.LAUNCHES["segmented_topk"] == before


def test_segmented_topk_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        segmented_topk.segmented_topk(torch.zeros(2, 8), 3)


def test_segmented_topk_sort_width():
    assert [segmented_topk.sort_width(k) for k in (1, 2, 3, 4096, 4097)] == \
        [1, 2, 4, 4096, 8192]


@pytest.mark.parametrize("num_sms", [1, 8, 132])
@pytest.mark.parametrize("S,C", [(8, 131_072), (13, 1_070_794), (1, 2**20 + 3),
                                 (1, 1), (1, 7), (4, 77), (13, 4097),
                                 (3, 100_003), (13, 100_001), (65_535, 5)])
def test_segmented_topk_chunks_cover_every_row(S, C, num_sms):
    """Each block of a row gets a non-empty chunk whose lanes start on a
    boundary of every vector width, and the chunks cover the row."""
    chunk, chunks = segmented_topk.geometry(S, C, num_sms)
    assert chunk % 4 == 0 and 1 <= chunks <= segmented_topk.MAX_CHUNKS
    starts = np.arange(chunks) * chunk
    assert starts[-1] < C <= chunks * chunk
    lanes = np.concatenate([np.arange(a, min(a + chunk, C)) for a in starts])
    np.testing.assert_array_equal(lanes, np.arange(C))


def test_segmented_topk_fills_the_card_at_path_shapes():
    """At the fleet frontier and the compressed plane, rows x chunks put
    at least one select block on every SM of an H100 (132)."""
    for S, C, want in ((8, 131_072, (4096, 32)),
                       (13, 1_070_794, (26_120, 41))):
        chunk, chunks = segmented_topk.geometry(S, C, 132)
        assert (chunk, chunks) == want and S * chunks >= 132


# ---------------------------------------------------------------------------
# mkp_utility
# ---------------------------------------------------------------------------

def mkp_inputs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.uniform(1, 10, n)
    w = rng.integers(0, 30, (n, m)).astype(float)
    r = 0.3 * w.sum(0) + rng.uniform(0, 1, m)
    r[0] = 0.0                                     # an exhausted knapsack
    sel = rng.uniform(size=n) < 0.7
    return v, w, r, sel


@pytest.mark.parametrize("n,m", [(1, 1), (19, 10), (37, 10), (64, 8),
                                 (200, 3), (513, 64)])
def test_mkp_utility_plain_matches_jax(n, m):
    v, w, r, sel = mkp_inputs(n, m, seed=n * m)
    port = ref.mkp_utility_ref(*(torch.as_tensor(a) for a in (v, w, r, sel)))
    want = np.asarray(jref.mkp_utility_ref(*(jnp.asarray(a)
                                             for a in (v, w, r, sel))))
    assert port.dtype == torch.float32
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(port.numpy()), fin)
    np.testing.assert_allclose(port.numpy()[fin], want[fin], rtol=1e-6)
    if n <= 64:
        pallas = np.asarray(jops.mkp_utility(*(jnp.asarray(a)
                                               for a in (v, w, r, sel)),
                                             interpret=True))
        np.testing.assert_array_equal(np.isfinite(pallas), fin)
        np.testing.assert_allclose(port.numpy()[fin], pallas[fin], rtol=1e-6)


def test_mkp_utility_sums_columns_left_to_right():
    v, w, r, sel = mkp_inputs(50, 10, seed=3)
    vt, wt, rt = (torch.as_tensor(a, dtype=torch.float32) for a in (v, w, r))
    got = ref.mkp_utility_ref(vt, wt, rt, torch.as_tensor(sel))
    s = 1.0 / np.maximum(r.astype(np.float32), np.float32(1e-12))
    pen = np.zeros(50, np.float32)
    for k in range(10):
        pen = pen + w[:, k].astype(np.float32) * s[k]
    fits = sel & np.all(w.astype(np.float32) <= r.astype(np.float32)
                        + np.float32(1e-12), axis=1)
    want = np.where(fits, v.astype(np.float32)
                    / np.maximum(pen, np.float32(1e-12)), -np.inf)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_mkp_utility_ops_cpu_counts_nothing():
    args = [torch.as_tensor(a) for a in mkp_inputs(30, 4)]
    before = ops.LAUNCHES["mkp_utility"]
    assert torch.equal(ops.mkp_utility(*args), ref.mkp_utility_ref(*args))
    assert ops.LAUNCHES["mkp_utility"] == before


def test_mkp_utility_kernel_refuses_cpu_tensors():
    args = [torch.as_tensor(a) for a in mkp_inputs(5, 2)]
    with pytest.raises(ValueError, match="CUDA"):
        mkp_utility.mkp_utility(*args)


@pytest.mark.parametrize("max_size", [None, 0, 4, 30, 40])
def test_mkp_greedy_ops_cpu_counts_nothing(max_size):
    v, w, r, _ = (torch.as_tensor(a, dtype=torch.float32)
                  for a in mkp_inputs(30, 4, seed=1))
    before = dict(ops.LAUNCHES)
    got = ops.mkp_greedy(v, w, r + 20, max_size)
    want = ref.mkp_greedy_ref(v, w, r + 20, max_size)
    assert ops.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0].sum()) <= (30 if max_size is None else max_size)


def test_mkp_greedy_kernel_refuses_cpu_tensors():
    v, w, r, _ = (torch.as_tensor(a, dtype=torch.float32)
                  for a in mkp_inputs(5, 2))
    with pytest.raises(ValueError, match="CUDA"):
        mkp_utility.mkp_greedy(v, w, r)


@pytest.mark.parametrize("P,want", [(1, 1), (16, 1), (4096, 1), (4097, 2),
                                    (1_070_794, 262), (2 ** 30, 288)])
def test_i8_aggregate_grid(P, want):
    """A thread a 16-column group, 256 threads a block, capped (the
    kernel strides past the cap)."""
    assert compression.i8_blocks(P) == want


def test_i8_aggregate_refuses_cpu_tensors():
    v = torch.zeros(3, 100, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        compression.fedavg_agg_quality_i8(v, torch.ones(3, 1),
                                          torch.ones(3) / 3)


# ---------------------------------------------------------------------------
# The serve path's ops: rmsnorm, swiglu, flash_attention
# ---------------------------------------------------------------------------

SERVE_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def both(shape, dtype, seed, mult=1.0):
    """The same seeded normals as a torch tensor and a jax array of
    ``dtype`` (bf16 rounded once, in torch, and handed over exactly)."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.as_tensor(a * np.float32(mult)).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.to(torch.float32).numpy()).astype(DTYPES[dtype][1])


def close(port, other, dtype):
    np.testing.assert_allclose(port.to(torch.float32).numpy(),
                               np.asarray(other, np.float32),
                               **SERVE_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (1, 256), (7, 960)])
def test_rmsnorm_plain_matches_oracle_and_pallas(shape, dtype):
    from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
    x, xj = both(shape, dtype, 0, mult=3.0)
    s, sj = both(shape[-1:], dtype, 1)
    port = ref.rmsnorm_ref(x, s)
    assert port.dtype == DTYPES[dtype][0] and port.shape == x.shape
    close(port, jref.rmsnorm_ref(xj, sj), dtype)
    close(port, pallas_rmsnorm(xj, sj, block_rows=4, interpret=True), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,D,F", [(16, 32, 48), (7, 64, 24), (64, 128, 256),
                                   (5, 50, 37)])
def test_swiglu_plain_matches_oracle_and_pallas(M, D, F, dtype):
    from repro.kernels.swiglu import swiglu as pallas_swiglu
    x, xj = both((M, D), dtype, 0)
    wg, wgj = both((D, F), dtype, 1, mult=0.1)
    wu, wuj = both((D, F), dtype, 2, mult=0.1)
    port = ref.swiglu_ref(x, wg, wu)
    assert port.dtype == DTYPES[dtype][0] and port.shape == (M, F)
    close(port, jref.swiglu_ref(xj, wgj, wuj), dtype)
    # The Pallas kernel does not mask a ragged K tail (its padded x and W
    # blocks hold garbage, NaN in interpret mode): one K block when D is
    # ragged. Ragged M and F tails only reach padded outputs.
    bk = 16 if D % 16 == 0 else D
    close(port, pallas_swiglu(xj, wgj, wuj, block_m=8, block_n=16,
                              block_k=bk, interpret=True), dtype)


def test_swiglu_plain_takes_leading_axes():
    x, _ = both((2, 3, 16), "float32", 0)
    wg, _ = both((16, 8), "float32", 1)
    wu, _ = both((16, 8), "float32", 2)
    got = ref.swiglu_ref(x, wg, wu)
    assert got.shape == (2, 3, 8)
    torch.testing.assert_close(got.reshape(6, 8),
                               ref.swiglu_ref(x.reshape(6, 16), wg, wu),
                               rtol=0, atol=0)


# (B, H, G, Sq, Sk, hd, causal, window): the sweep of tests/test_kernels.py
ATTN_CASES = {
    "mha": (1, 2, 2, 32, 32, 16, True, 0),
    "gqa_rep2": (2, 4, 2, 64, 64, 32, True, 0),
    "mqa_ragged": (1, 8, 1, 48, 48, 64, True, 0),
    "window8": (1, 2, 1, 64, 64, 16, True, 8),
    "window16": (1, 2, 1, 64, 64, 16, True, 16),
    "decode_sq1": (2, 4, 2, 1, 128, 32, True, 0),
    "noncausal": (1, 2, 2, 32, 32, 16, False, 0),
    "ragged_s40": (1, 2, 2, 40, 40, 16, True, 0),
    "sq_lt_sk_window": (1, 4, 2, 20, 50, 32, True, 12),
}


def attn_inputs(case, dtype, seed=0):
    B, H, G, Sq, Sk, hd, _, _ = ATTN_CASES[case]
    q = both((B, H, Sq, hd), dtype, seed)
    k = both((B, G, Sk, hd), dtype, seed + 1)
    v = both((B, G, Sk, hd), dtype, seed + 2)
    return q, k, v


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_plain_matches_oracle_and_pallas(case, dtype):
    from repro.kernels.flash_attention import flash_attention as pallas_fa
    causal, window = ATTN_CASES[case][6:]
    (q, qj), (k, kj), (v, vj) = attn_inputs(case, dtype)
    port = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert port.dtype == q.dtype and port.shape == q.shape
    close(port, jref.flash_attention_ref(qj, kj, vj, causal=causal,
                                         window=window), dtype)
    close(port, pallas_fa(qj, kj, vj, causal=causal, window=window,
                          block_q=16, block_k=16, interpret=True), dtype)


def test_serve_ops_cpu_take_plain_path_and_count_nothing():
    (q, _), (k, _), (v, _) = attn_inputs("gqa_rep2", "float32")
    x, _ = both((6, 32), "float32", 3)
    s, _ = both((32,), "float32", 4)
    wg, _ = both((32, 24), "float32", 5)
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s))
    assert torch.equal(ops.swiglu(x, wg, wg), ref.swiglu_ref(x, wg, wg))
    assert torch.equal(ops.flash_attention(q, k, v, window=8),
                       ref.flash_attention_ref(q, k, v, window=8))
    assert ops.LAUNCHES == before
    for name in ("rmsnorm", "swiglu", "flash_attention",
                 "flash_attention_bshd"):
        assert callable(getattr(ops.PLAIN, name))


def test_flash_attention_bshd_is_the_transposed_op():
    """Both adapters (kernel op and plain) swap axes 1 and 2 as views and
    agree with the reference's adapter."""
    (q, qj), (k, kj), (v, vj) = attn_inputs("gqa_rep2", "float32")
    t = lambda a: a.transpose(1, 2).contiguous()
    want = jops.flash_attention_bshd(*(jnp.swapaxes(a, 1, 2)
                                       for a in (qj, kj, vj)), window=16)
    for fn in (ops.flash_attention_bshd, ops.PLAIN.flash_attention_bshd):
        got = fn(t(q), t(k), t(v), causal=True, window=16)
        assert got.shape == t(q).shape
        close(got, want, "float32")


@pytest.mark.parametrize("fn,args", [
    ("rmsnorm", lambda: (torch.ones(2, 8), torch.ones(8))),
    ("swiglu", lambda: (torch.ones(2, 8), torch.ones(8, 4),
                        torch.ones(8, 4))),
    ("flash_attention", lambda: (torch.ones(1, 2, 4, 16),
                                 torch.ones(1, 1, 4, 16),
                                 torch.ones(1, 1, 4, 16)))])
def test_serve_kernel_wrappers_refuse_cpu_tensors(fn, args):
    from repro_torch.kernels import flash_attention, rmsnorm, swiglu
    mod = {"rmsnorm": rmsnorm, "swiglu": swiglu,
           "flash_attention": flash_attention}[fn]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(mod, fn)(*args())


def test_flash_attention_tensor_core_route():
    from repro_torch.kernels import flash_attention
    assert flash_attention.uses_mma(torch.bfloat16, 64)
    assert not flash_attention.uses_mma(torch.bfloat16, 48)
    assert not flash_attention.uses_mma(torch.float32, 64)


def test_flash_attention_hopper_route():
    """bf16 at hd 64 and 128 (SmolLM-360M's and Hymba-1.5B's 64 among
    them) takes the wgmma kernel; hd 16 and 32 keep mma.sync; f32 and
    other head sizes the CUDA-core kernel. ``uses_mma`` keeps its
    answers."""
    from repro_torch.kernels import flash_attention as kf
    bf, f32 = torch.bfloat16, torch.float32
    for hd in (64, 128):
        assert kf.uses_wgmma(bf, hd) and kf.route(bf, hd) == "wgmma"
    for hd in (16, 32, 48, 256):
        assert not kf.uses_wgmma(bf, hd)
    for hd in (16, 32, 64, 128):
        assert not kf.uses_wgmma(f32, hd) and kf.route(f32, hd) == "simple"
    assert kf.route(bf, 16) == kf.route(bf, 32) == "mma"
    assert kf.route(bf, 48) == "simple"
    assert [kf.uses_mma(bf, hd) for hd in (16, 32, 48, 64, 128, 256)] == [
        True, True, False, True, True, False]
    assert not kf.uses_mma(f32, 64)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_tma_describes_model_views(hd):
    """The models' (B, S, H, hd) tensors, viewed as (B, H, S, hd), are
    read in place by TMA; a base off 16 bytes, a row stride off 16 bytes
    and a strided hd axis are not (the wrapper copies those)."""
    from repro_torch.kernels import flash_attention as kf
    B, S, H, G = 2, 100, 15, 5
    for heads in (H, G):
        x = torch.zeros(B, S, heads, hd, dtype=torch.bfloat16)
        assert kf.tma_describable(x.transpose(1, 2))
    q1 = torch.zeros(B, 1, H, hd, dtype=torch.bfloat16)
    assert kf.tma_describable(q1.transpose(1, 2))              # Sq = 1
    flat = torch.zeros(B * S * H * hd + 8, dtype=torch.bfloat16)
    off = flat[1:1 + B * S * H * hd].view(B, S, H, hd)
    assert not kf.tma_describable(off.transpose(1, 2))
    padded = torch.zeros(B, S, H * hd + 4, dtype=torch.bfloat16)
    rows = padded[..., :H * hd].view(B, S, H, hd)              # S stride off
    assert not kf.tma_describable(rows.transpose(1, 2))
    assert not kf.tma_describable(
        torch.zeros(B, H, hd, S, dtype=torch.bfloat16).transpose(2, 3))
    f32 = torch.zeros(B, S, H, hd, dtype=torch.float32)
    assert kf.tma_describable(f32.transpose(1, 2))


@pytest.mark.parametrize("D,itemsize,vec,want", [
    (960, 2, True, 4), (1600, 2, True, 8), (2048, 2, True, 8),
    (2056, 2, True, 0), (256, 2, True, 1), (264, 2, True, 2),
    (960, 2, False, 0), (960, 4, True, 8), (1024, 4, True, 8),
    (1028, 4, True, 0), (64, 4, True, 1)])
def test_rmsnorm_vectors_per_lane(D, itemsize, vec, want):
    """SmolLM's D of 960 and Hymba's 1,600 in bf16 take the register
    kernel; rows past 2,048 bf16 or 1,024 f32, and rows without 16-byte
    loads, take the loop (0)."""
    from repro_torch.kernels import rmsnorm as krms
    assert krms.vectors_per_lane(D, itemsize, vec) == want
