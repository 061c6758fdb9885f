"""Port parity for the compressed update plane and the FedOpt server:
the codec grammar and byte accounting, the plain versions of the four
codec kernels, ``aggregate_compressed``, one round chunk through each
codec, and FedAdam/FedYogi, each against the JAX package on the CPU.

Tolerances, and why:

- grammar, ``bytes_per_client``, masks and the ``bytes`` column: exact
  (host arithmetic on the same integers);
- ``topk_sparsify_ref``, ``quantize_i8_ref``, ``dequantize_i8_ref``:
  exact against ``jax.jit`` of the JAX oracles and against the Pallas
  kernels in interpret mode. Under ``jit`` XLA folds the constant
  division ``amax / 127`` into ``amax * fl(1/127)``, the port's rule;
  the *eager* JAX oracle divides and may land 1 ulp of the scale away,
  so against it the scales are held to 1 ulp and the values to one
  int8 step (``test_quantize_eager_oracle_is_one_ulp_off``);
- ``fedavg_agg_quality_i8_ref`` and ``aggregate_compressed``: the codec
  payloads are exact, the f32 sums differ in order only: rtol 1e-5,
  atol 1e-5 (unit-normal data; sums of up to 1,000 terms);
- a round chunk (MNIST_CNN, S=3, K=4, dropout on): the two frameworks'
  deltas differ by about 1e-6 (ROADMAP Queue 3), which can move an int8
  value across a rounding boundary (one step, amax/127 of its chunk) or
  swap two |x| within 1e-6 of each other at the top-k threshold. So at
  most 0.1 % of the parameters may be off by more than the uncompressed
  tolerance (rtol 1e-4, atol 1e-5; seen: 0-3 of 206,922), and each of
  those by at most one int8 step, bounded by 1 % of the chunk's largest
  parameter change, or, where the codec keeps a top-k, by half that
  change (a swapped coordinate carries a value near the threshold,
  which on these deltas is under half the largest); q (a cosine over
  206,922 coordinates) within atol 1e-4;
- FedAdam/FedYogi: one step from the same moments and pseudo-gradient,
  rtol 1e-5 / atol 1e-6 (f32 elementwise, ``sqrt`` and division may
  round apart by an ulp); one chunk as the uncompressed chunk, rtol 1e-4
  / atol 1e-5 on params, atol 1e-4 on q.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.fl import compression as ref_comp
from repro.fl import device_data as ref_dd
from repro.fl.round import make_fl_rounds_scan as ref_scan
from repro.kernels import compression as pallas
from repro.kernels import ref as jref
from repro.models import cnn as jcnn
from repro_torch import optim
from repro_torch import random as trandom
from repro_torch.data.synthetic import make_classification_data
from repro_torch.fl import compression as comp
from repro_torch.fl import device_data
from repro_torch.fl.partition import partition_labels
from repro_torch.fl.round import make_fl_rounds_scan
from repro_torch.kernels import ops, ref
from repro_torch.models import cnn

SEED = 4


def t2n(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# grammar and byte accounting
# ---------------------------------------------------------------------------

SPECS = [None, "", "none", "int8", "int8@chunk=64", "topk:0.1",
         "topk:0.05+int8", "topk:0.05+int8@chunk=128", " TopK:0.3 ",
         "topk:1", "int8@chunk=100", "gzip", "topk:0", "topk:1.5",
         "int8@block=4", "int8@chunk=0", "topk:abc", 123]


@pytest.mark.parametrize("text", SPECS, ids=repr)
def test_spec_grammar_and_bytes_match_reference(text):
    """Parse, describe, k_for and bytes_per_client equal the reference's,
    and a spec the reference rejects is rejected with the same error
    type (the parse and reject cases of tests/test_compression.py)."""
    try:
        want = ref_comp.CompressionSpec.parse(text)
    except (TypeError, ValueError) as err:
        with pytest.raises(type(err)):
            comp.CompressionSpec.parse(text)
        return
    got = comp.CompressionSpec.parse(text)
    assert (got.kind, got.topk_frac, got.chunk, got.active) == \
        (want.kind, want.topk_frac, want.chunk, want.active)
    assert got.describe() == want.describe()
    assert comp.CompressionSpec.parse(got.describe()) == got
    for p in (1, 5, 257, 1000, 1_070_794):
        assert got.k_for(p) == want.k_for(p)
        for itemsize in (2, 4):
            assert comp.bytes_per_client(got, p, itemsize) == \
                ref_comp.bytes_per_client(want, p, itemsize)


def test_main_path_bytes():
    """The wire sizes of the card's service loop (CIFAR_CNN, P =
    1,070,794): int8 and topk:0.05+int8 against the raw f32 row."""
    p = 1_070_794
    assert comp.bytes_per_client(comp.CompressionSpec.parse(None), p) == \
        4_283_176
    assert comp.bytes_per_client(comp.CompressionSpec.parse("int8"), p) == \
        1_087_526
    assert comp.bytes_per_client(
        comp.CompressionSpec.parse("topk:0.05+int8"), p) == 268_540


# ---------------------------------------------------------------------------
# plain versions of the four kernels
# ---------------------------------------------------------------------------

def codec_input(K, P, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, P)).astype(np.float32)
    if kind == "ties":        # few magnitudes, both signs: ties everywhere
        x = (rng.integers(-3, 4, size=(K, P)) / 2).astype(np.float32)
        x[0, :3] = [-0.0, 0.0, -0.0]
    elif kind == "zeros":     # all-zero chunks, and a saturating extreme
        x[:, : P // 2] = 0.0
        x[-1, -1] = -1e4
    return x


TOPK_CASES = [(1, 7, 3, "normal"), (3, 130, 13, "normal"),
              (4, 257, 32, "ties"), (2, 64, 64, "ties"),
              (5, 512, 1, "normal"), (3, 100, 32, "zeros")]


@pytest.mark.parametrize("K,P,k,kind", TOPK_CASES)
def test_topk_sparsify_plain_exact(K, P, k, kind):
    """Exact against jit(lax.top_k oracle) and the Pallas kernel
    (interpret mode): the same indices, ties to the lowest index, and the
    same signed values."""
    x = codec_input(K, P, kind)
    got = [t2n(a) for a in ref.topk_sparsify_ref(torch.as_tensor(x), k)]
    want = jax.jit(jref.topk_sparsify_ref, static_argnums=1)(jnp.asarray(x), k)
    kern = pallas.topk_sparsify(jnp.asarray(x), k, interpret=True)
    for exp in (want, kern):
        np.testing.assert_array_equal(got[1], np.asarray(exp[1]))
        np.testing.assert_array_equal(got[0], np.asarray(exp[0]))
    assert got[1].dtype == np.int32 and got[0].dtype == np.float32


def test_topk_sparsify_plain_large_k_and_bf16():
    """k up to P and a bf16 input (cast to f32 first), against the jitted
    oracle at a width interpret mode would be slow for."""
    x = codec_input(3, 4000, "ties", seed=1)
    for k in (200, 4000, 5000):
        got = ref.topk_sparsify_ref(torch.as_tensor(x), k)
        want = jax.jit(jref.topk_sparsify_ref, static_argnums=1)(
            jnp.asarray(x), k)
        np.testing.assert_array_equal(t2n(got[1]), np.asarray(want[1]))
        np.testing.assert_array_equal(t2n(got[0]), np.asarray(want[0]))
    xb = torch.as_tensor(x).to(torch.bfloat16)
    got = ops.topk_sparsify(xb, 50)
    want = jax.jit(jref.topk_sparsify_ref, static_argnums=1)(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), 50)
    np.testing.assert_array_equal(t2n(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(t2n(got[0]), np.asarray(want[0]))


QUANT_CASES = [(1, 7, 256, "normal"), (3, 1000, 100, "normal"),
               (2, 257, 128, "zeros"), (4, 600, 32, "ties"),
               (13, 300, 512, "normal")]


@pytest.mark.parametrize("K,P,chunk,kind", QUANT_CASES)
def test_quantize_dequantize_plain_exact(K, P, chunk, kind):
    """Values and scales bit-equal to jit(oracle) and to the Pallas
    kernels (interpret mode); an all-zero chunk keeps scale 0; extremes
    saturate at ±127; dequantize bit-equal too."""
    x = codec_input(K, P, kind, seed=2)
    v, s = ref.quantize_i8_ref(torch.as_tensor(x), chunk)
    jv, js = jax.jit(jref.quantize_i8_ref, static_argnums=1)(
        jnp.asarray(x), chunk)
    pv, ps = pallas.quantize_i8(jnp.asarray(x), chunk=chunk, interpret=True)
    for ev, es in ((jv, js), (pv, ps)):
        np.testing.assert_array_equal(t2n(v), np.asarray(ev))
        np.testing.assert_array_equal(t2n(s), np.asarray(es))
    assert v.dtype == torch.int8 and s.shape == (K, -(-P // chunk))
    assert int(v.abs().max()) <= 127
    if kind == "zeros":
        assert (s[:, 0] == 0).all() and int(v[-1, -1]) == -127
    d = ref.dequantize_i8_ref(v, s, chunk)
    jd = jax.jit(jref.dequantize_i8_ref, static_argnums=2)(
        jnp.asarray(t2n(v)), jnp.asarray(t2n(s)), chunk)
    pd = pallas.dequantize_i8(jnp.asarray(t2n(v)), jnp.asarray(t2n(s)),
                              chunk=chunk, interpret=True)
    np.testing.assert_array_equal(t2n(d), np.asarray(jd))
    np.testing.assert_array_equal(t2n(d), np.asarray(pd))


def offset_view(x, offset):
    """x as a contiguous tensor ``offset`` elements into a larger buffer
    (a nonzero storage offset, its data_ptr off the buffer's alignment)."""
    x = torch.as_tensor(x)
    buf = torch.zeros(offset + x.numel(), dtype=x.dtype)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    assert view.storage_offset() == offset and view.is_contiguous()
    return view


# K, P, chunk, storage offset of x (f32 elements), of the int8 values
# (bytes), kind: P = 0, 2 and 1 or 3 mod 4, P below the chunk, both main
# path widths, chunks of 1 to 512
OFFSET_CASES = [(3, 7, 256, 1, 1, "normal"), (3, 100, 128, 3, 7, "zeros"),
                (5, 4096, 512, 2, 12, "normal"), (5, 4098, 256, 1, 2, "ties"),
                (5, 4097, 100, 3, 15, "normal"), (5, 4097, 1, 2, 5, "normal"),
                (4, 1030, 128, 2, 3, "zeros"), (4, 600, 32, 1, 11, "ties"),
                (2, 53_540, 256, 1, 4, "normal"),
                (2, 1_070_794, 256, 3, 9, "normal"),
                (3, 1000, 100, 2, 6, "nan"), (4, 600, 256, 3, 13, "inf")]


@pytest.mark.parametrize("K,P,chunk,x_off,v_off,kind", OFFSET_CASES)
def test_quantize_dequantize_plain_exact_at_storage_offsets(
        K, P, chunk, x_off, v_off, kind):
    """The plain versions on views at a storage offset (the inputs that
    the card tests give the kernels at misaligned addresses) equal
    jit(oracle) bit for bit, NaN as NaN."""
    x = codec_input(K, P, "normal" if kind in ("nan", "inf") else kind,
                    seed=3)
    if kind == "nan":
        x[:, 5::97] = np.nan
    elif kind == "inf":
        x[:, 5::97] = np.inf
        x[:, 300::389] = -np.inf
    v, s = ref.quantize_i8_ref(offset_view(x, x_off), chunk)
    jv, js = jax.jit(jref.quantize_i8_ref, static_argnums=1)(
        jnp.asarray(x), chunk)
    np.testing.assert_array_equal(t2n(v), np.asarray(jv))
    np.testing.assert_array_equal(t2n(s), np.asarray(js))
    d = ref.dequantize_i8_ref(offset_view(v, v_off), s, chunk)
    jd = jax.jit(jref.dequantize_i8_ref, static_argnums=2)(jv, js, chunk)
    np.testing.assert_array_equal(t2n(d), np.asarray(jd))
    assert np.isnan(t2n(s)).any() == (kind == "nan")


@pytest.mark.parametrize("kind", ["nan", "posinf", "neginf", "mixed"])
@pytest.mark.parametrize("K,P,chunk", [(4, 600, 256), (3, 1000, 100)])
def test_quantize_plain_keeps_non_finite_as_jax(K, P, chunk, kind):
    """Chunks holding NaN or +-inf, against jit(oracle) and the Pallas
    kernel (interpret mode), exactly (NaN compared as NaN): a NaN chunk
    gets scale NaN and values 0; a +-inf chunk gets scale inf, its
    finite values 0 and its +-inf values 0 (XLA's NaN-to-int8 cast).
    Dequantize and the int8 aggregate carry the NaN through."""
    x = codec_input(K, P, "normal", seed=4)
    bad = {"nan": [np.nan], "posinf": [np.inf], "neginf": [-np.inf],
           "mixed": [np.nan, np.inf, -np.inf]}[kind]
    for i, v in enumerate(bad * K):                 # one bad chunk a row,
        x[i % K, (i * 131 + 7) % P] = v             # others left finite
    v, s = ref.quantize_i8_ref(torch.as_tensor(x), chunk)
    jv, js = jax.jit(jref.quantize_i8_ref, static_argnums=1)(
        jnp.asarray(x), chunk)
    pv, ps = pallas.quantize_i8(jnp.asarray(x), chunk=chunk, interpret=True)
    for ev, es in ((jv, js), (pv, ps)):
        np.testing.assert_array_equal(t2n(v), np.asarray(ev))
        np.testing.assert_array_equal(t2n(s), np.asarray(es))
    sn = t2n(s)
    assert not np.isfinite(sn).all() and np.isfinite(sn).any()
    for row, col in zip(*np.nonzero(~np.isfinite(sn))):
        assert (t2n(v)[row, col * chunk:(col + 1) * chunk] == 0).all()
    d = ref.dequantize_i8_ref(v, s, chunk)
    jd = jax.jit(jref.dequantize_i8_ref, static_argnums=2)(
        jnp.asarray(t2n(v)), jnp.asarray(sn), chunk)
    np.testing.assert_array_equal(t2n(d), np.asarray(jd))
    assert np.isnan(t2n(d)).any()
    w = torch.full((K,), 1.0 / K)
    agg = ref.fedavg_agg_quality_i8_ref(v, s, w, chunk)
    jagg = jax.jit(jref.fedavg_agg_quality_i8_ref, static_argnums=3)(
        jnp.asarray(t2n(v)), jnp.asarray(sn), jnp.asarray(t2n(w)), chunk)
    for a, b in zip(agg, jagg):
        np.testing.assert_array_equal(np.isnan(t2n(a)), np.isnan(
            np.asarray(b)))


def test_quantize_scale_is_reciprocal_multiply():
    """The jitted oracle's scale is amax * fl(1/127) to the bit, as the
    port's; the port's values are round_half_even of a true division."""
    x = codec_input(5, 3000, "normal", seed=3)
    _, js = jax.jit(jref.quantize_i8_ref, static_argnums=1)(
        jnp.asarray(x), 256)
    pad = np.pad(np.abs(x), ((0, 0), (0, 12 * 256 - 3000)))
    amax = pad.reshape(5, 12, 256).max(axis=2)
    np.testing.assert_array_equal(np.asarray(js),
                                  amax * (np.float32(1) / np.float32(127)))
    v, s = ref.quantize_i8_ref(torch.as_tensor(x), 256)
    q = np.round(x / np.repeat(t2n(s), 256, axis=1)[:, :3000])
    np.testing.assert_array_equal(t2n(v), np.clip(q, -127, 127))


def test_quantize_eager_oracle_is_one_ulp_off():
    """Against the eager JAX oracle (amax / 127 as a true division) the
    scales agree within 1 ulp and the values within one int8 step."""
    x = codec_input(5, 3000, "normal", seed=3)
    v, s = ref.quantize_i8_ref(torch.as_tensor(x), 256)
    ev, es = jref.quantize_i8_ref(jnp.asarray(x), 256)
    ulps = np.abs(t2n(s).view(np.int32) - np.asarray(es).view(np.int32))
    assert ulps.max() <= 1
    assert np.abs(t2n(v).astype(int) - np.asarray(ev).astype(int)).max() <= 1


@pytest.mark.parametrize("K,P,chunk", [(1, 7, 256), (3, 1000, 100),
                                       (13, 600, 128), (4, 257, 64)])
def test_fedavg_agg_quality_i8_plain(K, P, chunk):
    """Against jit(oracle) and the Pallas kernel: rtol 1e-5 (f32 sums in
    another order)."""
    x = codec_input(K, P, "normal", seed=5)
    w = np.random.default_rng(5).random(K).astype(np.float32)
    w /= w.sum()
    v, s = ref.quantize_i8_ref(torch.as_tensor(x), chunk)
    got = ref.fedavg_agg_quality_i8_ref(v, s, torch.as_tensor(w), chunk)
    jv, js = jnp.asarray(t2n(v)), jnp.asarray(t2n(s))
    want = jax.jit(jref.fedavg_agg_quality_i8_ref, static_argnums=3)(
        jv, js, jnp.asarray(w), chunk)
    kern = pallas.fedavg_agg_quality_i8(jv, js, jnp.asarray(w), chunk=chunk,
                                        interpret=True)
    assert got[0].dtype == torch.float32 and got[0].shape == (P,)
    for exp in (want, kern):
        for a, b in zip(got, exp):
            np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)


def test_ops_cpu_takes_plain_versions_and_counts_nothing():
    x = torch.as_tensor(codec_input(3, 300, "normal"))
    w = torch.full((3,), 1 / 3)
    before = dict(ops.LAUNCHES)
    v, s = ops.quantize_i8(x, 64)
    outs = [ops.topk_sparsify(x, 9), (v, s), ops.dequantize_i8(v, s, 64),
            ops.fedavg_agg_quality_i8(v, s, w, 64)]
    exps = [ref.topk_sparsify_ref(x, 9), ref.quantize_i8_ref(x, 64),
            ref.dequantize_i8_ref(v, s, 64),
            ref.fedavg_agg_quality_i8_ref(v, s, w, 64)]
    for got, exp in zip(outs, exps):
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        exp if isinstance(exp, tuple) else (exp,)):
            assert torch.equal(a, b)
    assert ops.LAUNCHES == before
    assert {"topk_sparsify", "quantize_i8", "dequantize_i8",
            "fedavg_agg_quality_i8"} <= set(ops.LAUNCHES)


def test_kernel_bindings_refuse_cpu_tensors():
    from repro_torch.kernels import compression as kc
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kc.topk_sparsify(x, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kc.quantize_i8(x)
    v = torch.zeros(2, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        kc.dequantize_i8(v, torch.zeros(2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        kc.fedavg_agg_quality_i8(v, torch.zeros(2, 1), torch.ones(2))


@pytest.mark.parametrize("text", ["topk:0.05+int8", "topk:0.1", "topk:1"])
@pytest.mark.parametrize("P", [1_070_794, 206_922, 4097, 7])
def test_topk_codec_launch_geometry(text, P):
    """What the top-k kernel's wrapper derives at each codec's k: the
    sort width holds k, and the chunks of a row cover it with no empty
    block."""
    from repro_torch.kernels import segmented_topk as st
    K = 13
    k = comp.CompressionSpec.parse(text).k_for(P)
    assert 1 <= k <= P
    kp = st.sort_width(k)
    assert kp >= k and kp & (kp - 1) == 0 and kp < 2 * k
    chunk, chunks = st.geometry(K, P, 132)
    assert (chunks - 1) * chunk < P <= chunks * chunk and chunk % 4 == 0


# ---------------------------------------------------------------------------
# the codec layer
# ---------------------------------------------------------------------------

AGG_SPECS = ["int8", "topk:0.1", "topk:0.05+int8", "int8@chunk=128"]


@pytest.mark.parametrize("text", AGG_SPECS)
def test_aggregate_compressed_matches_reference(text):
    """The same flat deltas through both packages (the reference jitted,
    as its round scan is): payloads exact, the aggregate and Gram terms
    within rtol 1e-5; the port's decode equals its own roundtrip."""
    rng = np.random.default_rng(7)
    flat = (rng.standard_normal((5, 3001)) * 0.01).astype(np.float32)
    w = rng.random(5).astype(np.float32)
    w /= w.sum()
    spec, jspec = comp.CompressionSpec.parse(text), \
        ref_comp.CompressionSpec.parse(text)
    payload = comp.compress(torch.as_tensor(flat), spec)
    jpayload = jax.jit(functools.partial(ref_comp.compress, spec=jspec))(
        jnp.asarray(flat))
    assert sorted(payload) == sorted(jpayload)
    for key in payload:
        np.testing.assert_array_equal(t2n(payload[key]),
                                      np.asarray(jpayload[key]))
    got = comp.aggregate_compressed(torch.as_tensor(flat),
                                    torch.as_tensor(w), spec)
    want = jax.jit(functools.partial(ref_comp.aggregate_compressed,
                                     spec=jspec))(jnp.asarray(flat),
                                                  jnp.asarray(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    dec = comp.roundtrip(torch.as_tensor(flat), spec)
    np.testing.assert_array_equal(
        t2n(dec), np.asarray(jax.jit(functools.partial(
            ref_comp.roundtrip, spec=jspec))(jnp.asarray(flat))))
    np.testing.assert_allclose(t2n(got[0]), w @ t2n(dec), rtol=1e-5,
                               atol=1e-6)


def test_plain_kernels_argument_runs_the_same_codec():
    """``kernels=ops.PLAIN`` gives what the dispatching ops give on the
    CPU, bit for bit (on the card it holds the kernels against it)."""
    flat = torch.as_tensor(codec_input(4, 900, "normal", seed=8))
    w = torch.full((4,), 0.25)
    for text in AGG_SPECS:
        spec = comp.CompressionSpec.parse(text)
        a = comp.aggregate_compressed(flat, w, spec)
        b = comp.aggregate_compressed(flat, w, spec, kernels=ops.PLAIN)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# FedAdam / FedYogi
# ---------------------------------------------------------------------------

OPTS = [("fedadam", {}), ("fedyogi", {}), ("adam", {}),
        ("adamw", {}), ("sgd", {"momentum": 0.9})]


@pytest.mark.parametrize("name,kw", OPTS, ids=[o[0] for o in OPTS])
def test_optimizer_steps_match_reference(name, kw):
    """Three steps from the same params and pseudo-gradients: updates and
    states within rtol 1e-5 / atol 1e-6, counts equal."""
    rng = np.random.default_rng(11)
    shapes = {"a.w": (7, 3), "a.b": (3,), "b.w": (3, 5)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    o = optim.make(name, 0.05, **kw)
    jo = ref_optim.make(name, 0.05, **kw)
    tp = {n: torch.as_tensor(v) for n, v in params.items()}
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    st, jst = o.init(tp), jo.init(jp)
    for _ in range(3):
        g = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for n, s in shapes.items()}
        upd, st = o.update({n: torch.as_tensor(v) for n, v in g.items()},
                           st, tp)
        jupd, jst = jo.update({n: jnp.asarray(v) for n, v in g.items()},
                              jst, jp)
        tp, jp = optim.apply_updates(tp, upd), ref_optim.apply_updates(jp,
                                                                      jupd)
        for n in shapes:
            np.testing.assert_allclose(t2n(upd[n]), np.asarray(jupd[n]),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(t2n(tp[n]), np.asarray(jp[n]),
                                       rtol=1e-5, atol=1e-6)
    assert int(st["count"]) == int(jst["count"]) == 3
    assert st["count"].dtype == torch.int32
    for key in set(st) - {"count"}:
        for n in shapes:
            assert st[key][n].dtype == torch.float32
            np.testing.assert_allclose(t2n(st[key][n]),
                                       np.asarray(jst[key][n]), rtol=1e-5,
                                       atol=1e-7)


def test_schedules_and_global_norm_match_reference():
    from repro.optim import schedules as jsched
    from repro_torch.optim import schedules
    for mk in (lambda m: m.warmup_cosine(0.1, 10, 100, 0.01),
               lambda m: m.inverse_sqrt(0.1, 10), lambda m: m.constant(0.3)):
        f, jf = mk(schedules), mk(jsched)
        for c in (1, 5, 10, 11, 50, 100, 150):
            np.testing.assert_allclose(
                float(f(torch.tensor(c, dtype=torch.int32))),
                float(jf(jnp.asarray(c, jnp.int32))), rtol=1e-6)
    tree = {"a": np.arange(6, dtype=np.float32), "b": -np.ones(3, np.float32)}
    np.testing.assert_allclose(
        float(optim.global_norm({k: torch.as_tensor(v)
                                 for k, v in tree.items()})),
        float(ref_optim.global_norm(tree)), rtol=1e-6)


# ---------------------------------------------------------------------------
# one round chunk through each codec, and with a server optimizer
# ---------------------------------------------------------------------------

ROWS = np.array([[0, 3, 5, 0], [1, 2, 6, 7], [4, 0, 0, 0]], np.int64)
ACTIVE = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0]], np.float32)
KW = dict(local_lr=0.1, local_steps=2, batch_size=8, server_lr=1.0,
          dropout_rate=0.4)


@pytest.fixture(scope="module")
def chunk_setup():
    data = make_classification_data("mnist", 300, seed=SEED)
    parts = partition_labels(data.labels, 8, "type2", 10, seed=SEED)
    parts[5] = parts[5][:0]                  # an empty client: inactive slot
    weights = ACTIVE * np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    round_ids = np.array([5, 6, 7])
    jsched = {"rows": jnp.asarray(ROWS, jnp.int32),
              "weights": jnp.asarray(weights),
              "active": jnp.asarray(ACTIVE),
              "round_ids": jnp.asarray(round_ids, jnp.int32)}
    sched = {"rows": torch.as_tensor(ROWS),
             "weights": torch.as_tensor(weights),
             "active": torch.as_tensor(ACTIVE),
             "round_ids": torch.as_tensor(round_ids)}
    return {"data": data, "parts": parts, "jsched": jsched, "sched": sched,
            "jdata": ref_dd.DeviceDataset.stage(data, parts),
            "dd": device_data.DeviceDataset.stage(data, parts, "cpu")}


def run_both(setup, compression=None, server_opt=None, server_lr=1.0):
    """One chunk through the reference and the port from the same
    parameters; returns numpy params and infos of both, and the port's
    torch outputs."""
    kw = dict(KW, server_lr=server_lr)
    jparams = jcnn.init_params(jcnn.MNIST_CNN, jax.random.PRNGKey(SEED))
    params0 = cnn.params_from_jax(jax.tree_util.tree_map(np.array, jparams))
    jopt = None if server_opt is None else ref_optim.make(server_opt,
                                                          server_lr)
    topt = None if server_opt is None else optim.make(server_opt, server_lr)
    jfn = ref_scan(lambda p, b: jcnn.loss_fn(jcnn.MNIST_CNN, p, b,
                                             impl="reference"),
                   compression=compression, server_opt=jopt, **kw)
    fn = make_fl_rounds_scan(lambda p, b: cnn.loss_fn(cnn.MNIST_CNN, p, b),
                             compression=compression, server_opt=topt, **kw)
    jcarry = jparams if jopt is None else (jparams, jopt.init(jparams))
    carry = params0 if topt is None else (params0, topt.init(params0))
    jout, jinfo = jfn(jcarry, setup["jdata"], setup["jsched"],
                      jax.random.PRNGKey(SEED))
    out, info = fn(carry, setup["dd"], setup["sched"],
                   trandom.prng_key(SEED))
    if topt is not None:
        (jout, jstate), (out, state) = jout, out
        assert int(state["count"]) == int(jstate["count"]) == 3
    jflat = {f"{layer}.{leaf}": np.asarray(jout[layer][leaf])
             for layer in cnn.LAYERS for leaf in ("w", "b")}
    return jflat, jax.tree_util.tree_map(np.asarray, jinfo), out, info


CODECS = ["int8", "topk:0.05", "topk:0.05+int8", "int8@chunk=100"]


@pytest.mark.parametrize("text", CODECS)
def test_compressed_chunk_matches_reference(chunk_setup, text):
    jout, jinfo, out, info = run_both(chunk_setup, compression=text)
    np.testing.assert_array_equal(t2n(info["masks"]), jinfo["masks"])
    assert (t2n(info["masks"]) < ACTIVE).any(), "dropout never fired"
    p = sum(v.numel() for v in out.values())
    per_client = comp.bytes_per_client(comp.CompressionSpec.parse(text), p)
    np.testing.assert_array_equal(t2n(info["bytes"]), jinfo["bytes"])
    np.testing.assert_array_equal(t2n(info["bytes"]),
                                  t2n(info["masks"]).sum(1) * per_client)
    change = max(float(np.abs(jout[n] - jcnn_init(n)).max()) for n in jout)
    flip = (0.5 if text.startswith("topk") else 0.01) * change
    off, total = 0, 0
    for n, v in out.items():
        a, b = t2n(v), jout[n]
        err = np.abs(a - b)
        off += int((err > 1e-5 + 1e-4 * np.abs(b)).sum())
        total += a.size
        assert err.max() <= flip, (n, err.max(), flip)
    assert off <= 0.001 * total, (off, total)
    np.testing.assert_allclose(t2n(info["q_values"]), jinfo["q_values"],
                               atol=1e-4)
    np.testing.assert_allclose(t2n(info["client_losses"]),
                               jinfo["client_losses"], rtol=1e-4, atol=1e-5)


def jcnn_init(name):
    layer, leaf = name.split(".")
    return np.asarray(jcnn.init_params(jcnn.MNIST_CNN,
                                       jax.random.PRNGKey(SEED))[layer][leaf])


def test_none_is_bit_identical_to_uncompressed(chunk_setup):
    """``compression="none"`` runs exactly the uncompressed chunk, with
    no bytes column."""
    runs = [run_both(chunk_setup, compression=c)[2:] for c in (None, "none")]
    (a, ia), (b, ib) = runs
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert sorted(ia) == sorted(ib) and "bytes" not in ia
    assert all(torch.equal(ia[k], ib[k]) for k in ia)


@pytest.mark.parametrize("name", ["fedadam", "fedyogi"])
def test_server_opt_chunk_matches_reference(chunk_setup, name):
    jout, jinfo, out, info = run_both(chunk_setup, server_opt=name,
                                      server_lr=0.01)
    np.testing.assert_array_equal(t2n(info["masks"]), jinfo["masks"])
    for n in out:
        np.testing.assert_allclose(t2n(out[n]), jout[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    np.testing.assert_allclose(t2n(info["q_values"]), jinfo["q_values"],
                               atol=1e-4)
    np.testing.assert_allclose(t2n(info["mean_loss"]), jinfo["mean_loss"],
                               rtol=1e-4, atol=1e-5)
