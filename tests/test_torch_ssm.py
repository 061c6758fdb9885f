"""Port parity for the SSM layers: ``repro_torch.models.ssm``, the plain
versions of the ``mlstm_scan`` kernel (``kernels.ref.mlstm_scan_ref``,
``mlstm_scan_state_ref``) and its CPU dispatch in ``kernels.ops``,
against the JAX package's ``models/ssm.py``, ``kernels/ref.py`` and
Pallas kernel (interpret mode), on the same numpy-seeded inputs and, for
the blocks, the reference's parameters carried across.

Tolerances. Both sides compute in f32 and differ only in the order of
f32 sums (cumsum, einsum, matmul) and in ``exp`` / ``log`` rounding:
the scan, its state and the decode step agree to rtol = atol = 2e-5 on
the unit-scale inputs below (outputs up to about 10). The blocks run
projections, norms and the scan in sequence, and the sLSTM runs its
recurrence step by step: rtol = atol = 1e-4. Against the Pallas kernel
in interpret mode the reference's own tolerance holds, 5e-4
(tests/test_kernels.py). In bf16 both sides compute in f32 and round
once to bf16: within one bf16 ulp (rtol 2**-7), with an atol of 1e-5 for
outputs near zero. The layout adapter and the CPU dispatch run the
plain version itself: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mlstm_scan import mlstm_scan as pallas_mlstm_scan
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.kernels import mlstm_scan as kmlstm
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as S

TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
PALLAS_TOL = dict(rtol=5e-4, atol=5e-4)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def close(port, other, **tol):
    np.testing.assert_allclose(port.detach().to(torch.float32).numpy(),
                               np.asarray(other, np.float32),
                               **(tol or TOL))


def pair(a):
    """A numpy array as a (torch, jax) pair."""
    a = np.ascontiguousarray(a)
    return torch.as_tensor(a.copy()), jnp.asarray(a)


def gla_inputs(B, S_, H, dk, dv, seed, normalize, layout="bshd"):
    """q, k, v, log_f, log_i as in the reference's tests (k scaled by
    0.3, log f = log_sigmoid(N + 2), log i = 0.5 N or None), each a
    (torch, jax) pair; ``layout`` "bhsd" for the kernel's axes."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = n(B, S_, H, dk), n(B, S_, H, dk) * np.float32(0.3), n(B, S_, H, dv)
    log_f = -np.logaddexp(0.0, -(n(B, S_, H) + 2.0)).astype(np.float32)
    log_i = n(B, S_, H) * np.float32(0.5) if normalize else None
    if layout == "bhsd":
        q, k, v = (np.moveaxis(a, 2, 1) for a in (q, k, v))
        log_f = np.moveaxis(log_f, 2, 1)
        log_i = None if log_i is None else np.moveaxis(log_i, 2, 1)
    out = [pair(a) for a in (q, k, v, log_f)]
    out.append((None, None) if log_i is None else pair(log_i))
    return out


def state_pair(B, H, dk, dv, seed):
    rng = np.random.default_rng(seed)
    st = {"S": rng.standard_normal((B, H, dk, dv)).astype(np.float32) * 0.5,
          "n": rng.standard_normal((B, H, dk)).astype(np.float32) * 0.5,
          "m": rng.standard_normal((B, H)).astype(np.float32) * 0.2}
    return ({k: torch.as_tensor(v) for k, v in st.items()},
            {k: jnp.asarray(v) for k, v in st.items()})


def close_state(got, want, **tol):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == torch.float32
        close(got[name], want[name], **tol)


# ---------------------------------------------------------------------------
# The scan and the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
@pytest.mark.parametrize("seq,chunk", [(16, 4), (17, 4), (32, 32), (7, 16),
                                       (40, 16), (70, 32)])
def test_gated_linear_attention_matches_reference(seq, chunk, normalize):
    """Output and final state, ragged S (a padded tail) included."""
    (q, qj), (k, kj), (v, vj), (f, fj), (i, ij) = gla_inputs(
        2, seq, 3, 8, 5, seq * 31 + chunk, normalize)
    out, state = S.gated_linear_attention(q, k, v, f, i, chunk=chunk,
                                          normalize=normalize)
    jout, jstate = JS.gated_linear_attention(qj, kj, vj, fj, ij, chunk=chunk,
                                             normalize=normalize)
    assert out.shape == (2, seq, 3, 5) and out.dtype == torch.float32
    close(out, jout)
    close_state(state, jstate)


@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
def test_gated_linear_attention_initial_state(normalize):
    """A given initial state is read instead of zeros (m != 0 too), and
    [a; b] in one call equals a then b with the state carried."""
    (q, qj), (k, kj), (v, vj), (f, fj), (i, ij) = gla_inputs(
        1, 20, 2, 4, 6, 5, normalize)
    st, jst = state_pair(1, 2, 4, 6, 6)
    out, state = S.gated_linear_attention(q, k, v, f, i, chunk=8,
                                          normalize=normalize,
                                          initial_state=st)
    jout, jstate = JS.gated_linear_attention(qj, kj, vj, fj, ij, chunk=8,
                                             normalize=normalize,
                                             initial_state=jst)
    close(out, jout)
    close_state(state, jstate)
    whole, s_whole = S.gated_linear_attention(q, k, v, f, i, chunk=4,
                                              normalize=normalize)
    cut = lambda x, a, b: None if x is None else x[:, a:b]
    first, s1 = S.gated_linear_attention(q[:, :12], k[:, :12], v[:, :12],
                                         f[:, :12], cut(i, 0, 12), chunk=4,
                                         normalize=normalize)
    second, s2 = S.gated_linear_attention(q[:, 12:], k[:, 12:], v[:, 12:],
                                          f[:, 12:], cut(i, 12, 20), chunk=4,
                                          normalize=normalize,
                                          initial_state=s1)
    torch.testing.assert_close(torch.cat([first, second], 1), whole,
                               rtol=2e-4, atol=2e-4)
    true = lambda s: s["S"] * torch.exp(s["m"])[..., None, None]
    torch.testing.assert_close(true(s2), true(s_whole), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
def test_gla_decode_step_matches_reference(normalize):
    (q, qj), (k, kj), (v, vj), (f, fj), (i, ij) = gla_inputs(
        3, 1, 2, 6, 4, 7, normalize)
    st, jst = state_pair(3, 2, 6, 4, 8)
    if not normalize:               # the SSD form carries m = 0
        st["m"], jst["m"] = torch.zeros(3, 2), jnp.zeros((3, 2))
    sq = lambda x: None if x is None else x[:, 0]
    y, new = S.gla_decode_step(sq(q), sq(k), sq(v), sq(f), sq(i), st,
                               normalize=normalize)
    jy, jnew = JS.gla_decode_step(sq(qj), sq(kj), sq(vj), sq(fj), sq(ij),
                                  jst, normalize=normalize)
    assert y.shape == (3, 2, 4)
    close(y, jy)
    close_state(new, jnew)


@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
def test_chunked_scan_matches_the_step_recurrence(normalize):
    """The port's chunked form against its own decode step, token by
    token (the reference's check, tests/test_models_core.py): 2e-4."""
    (q, _), (k, _), (v, _), (f, _), (i, _) = gla_inputs(2, 17, 3, 8, 5, 9,
                                                        normalize)
    out, final = S.gated_linear_attention(q, k, v, f, i, chunk=4,
                                          normalize=normalize)
    state = {"S": torch.zeros(2, 3, 8, 5), "n": torch.zeros(2, 3, 8),
             "m": torch.zeros(2, 3)}
    outs = []
    for t in range(17):
        y, state = S.gla_decode_step(q[:, t], k[:, t], v[:, t], f[:, t],
                                     None if i is None else i[:, t], state,
                                     normalize=normalize)
        outs.append(y)
    torch.testing.assert_close(out, torch.stack(outs, 1), rtol=2e-4,
                               atol=2e-4)
    true = lambda s: s["S"] * torch.exp(s["m"])[..., None, None]
    torch.testing.assert_close(true(final), true(state), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Conv and sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 2, 3, 9])
def test_causal_conv1d_and_conv_cache_match_reference(seq):
    """Prefill conv, a decode conv from a cache, and the cache left after
    a prefill of ``seq`` tokens (left-padded when seq < K - 1 = 3)."""
    rng = np.random.default_rng(seq)
    x, xj = pair(rng.standard_normal((2, seq, 12)).astype(np.float32))
    w, wj = pair(rng.standard_normal((4, 12)).astype(np.float32) * 0.5)
    y, none = S.causal_conv1d(x, w)
    jy, _ = JS.causal_conv1d(xj, wj)
    assert none is None
    close(y, jy)
    cache, jcache = S.conv_cache_from(x, 4), JS.conv_cache_from(xj, 4)
    assert cache.shape == (2, 3, 12)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))
    step, stepj = pair(rng.standard_normal((2, 1, 12)).astype(np.float32))
    y1, c1 = S.causal_conv1d(step, w, cache)
    jy1, jc1 = JS.causal_conv1d(stepj, wj, jcache)
    close(y1, jy1)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc1))


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply_matches_reference(with_state):
    cfg = jget("xlstm-125m").reduced(d_model=64)
    jp = JS.slstm_block_params(cfg, jax.random.PRNGKey(4))
    p = {k: torch.as_tensor(np.array(jp[k]))
         for k in ("w_gates", "b_gates", "r_gates")}
    x, xj = pair(np.random.default_rng(5).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32))
    st = jst = None
    if with_state:
        rng = np.random.default_rng(6)
        dh = cfg.d_model // cfg.num_heads
        arrs = {k: rng.standard_normal((2, cfg.num_heads, dh)).astype(
            np.float32) * 0.3 for k in ("c", "h", "m")}
        arrs["n"] = np.abs(arrs["c"]) + 1.0
        st = {k: torch.as_tensor(v) for k, v in arrs.items()}
        jst = {k: jnp.asarray(v) for k, v in arrs.items()}
    out, state = S.slstm_apply(p, x, cfg.num_heads, st)
    jout, jstate = JS.slstm_apply({k: jp[k] for k in p}, xj, cfg.num_heads,
                                  jst)
    close(out, jout, **BLOCK_TOL)
    close_state(state, jstate, **BLOCK_TOL)


# ---------------------------------------------------------------------------
# Blocks, prefill and decode, on the reference's parameters
# ---------------------------------------------------------------------------

BLOCKS = {"mlstm": ("xlstm-125m", JS.mlstm_block_params),
          "slstm": ("xlstm-125m", JS.slstm_block_params),
          "mamba": ("hymba-1.5b", JS.mamba_head_params)}


def block_pair(kind):
    arch, params = BLOCKS[kind]
    jcfg = jget(arch).reduced()
    jp = params(jcfg, jax.random.PRNGKey(7))
    tp = jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a)), jp)
    return get_config(arch).reduced(), jcfg, tp, jp


def apply_block(kind, mod, cfg, p, x, state=None, conv=None, **kw):
    if kind == "mlstm":
        return mod.mlstm_block_apply(cfg, p, x, state, conv, **kw)
    if kind == "mamba":
        return mod.mamba_head_apply(cfg, p, x, state, conv, **kw)
    out, st = mod.slstm_block_apply(cfg, p, x, state)
    return out, (st, None)


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_prefill_and_decode_match_reference(kind):
    """Prefill over 40 tokens (a ragged last chunk at chunk 32) building
    the caches, then 3 decode steps from them."""
    cfg, jcfg, p, jp = block_pair(kind)
    rng = np.random.default_rng(8)
    x, xj = pair(rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32))
    out, (st, conv) = apply_block(kind, S, cfg, p, x, build_cache=True)
    jout, (jst, jconv) = apply_block(kind, JS, jcfg, jp, xj, build_cache=True)
    close(out, jout, **BLOCK_TOL)
    close_state(st, jst, **BLOCK_TOL)
    if kind != "slstm":               # the last inputs u = h @ w_in
        close(conv, jconv)
    for step in range(3):
        t, tj = pair(rng.standard_normal((2, 1, cfg.d_model)).astype(
            np.float32))
        out, (st, conv) = apply_block(kind, S, cfg, p, t, st, conv,
                                      decode=True)
        jout, (jst, jconv) = apply_block(kind, JS, jcfg, jp, tj, jst, jconv,
                                         decode=True)
        close(out, jout, **BLOCK_TOL)
        close_state(st, jst, **BLOCK_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "mamba"])
def test_block_scan_seam(kind):
    """``scan_fn`` takes the prefill scan with gated_linear_attention's
    signature: the kernel's adapter (on the CPU its plain version) gives
    the same block output and state; decode never calls it."""
    cfg, _, p, _ = block_pair(kind)
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (2, 33, cfg.d_model)).astype(np.float32))
    calls = []

    def scan(*a, **k):
        calls.append(k["normalize"])
        return ops.mlstm_scan_bshd(*a, **k)
    want, (wst, _) = apply_block(kind, S, cfg, p, x, build_cache=True)
    got, (st, conv) = apply_block(kind, S, cfg, p, x, build_cache=True,
                                  scan_fn=scan)
    assert calls == [kind == "mlstm"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    close_state(st, {k: v.numpy() for k, v in wst.items()}, rtol=0, atol=0)
    apply_block(kind, S, cfg, p, x[:, :1], st, conv, decode=True,
                scan_fn=scan)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# The kernel's plain versions and dispatch
# ---------------------------------------------------------------------------

SWEEP = [(32, 8), (40, 16), (16, 16)]     # tests/test_kernels.py::TestMLSTMScan


@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
@pytest.mark.parametrize("seq,chunk", SWEEP)
def test_mlstm_scan_ref_matches_reference_and_pallas(seq, chunk, normalize):
    """(B, H, S, d) layout, B, H, dk, dv = 2, 3, 16, 8: the port's
    ``ref.mlstm_scan_ref`` against the reference's oracle (2e-5) and its
    Pallas kernel in interpret mode (5e-4); the state variant's output
    is the same tensor."""
    (q, qj), (k, kj), (v, vj), (f, fj), (i, ij) = gla_inputs(
        2, seq, 3, 16, 8, seq + chunk, normalize, layout="bhsd")
    got = ref.mlstm_scan_ref(q, k, v, f, i, chunk=chunk, normalize=normalize)
    assert got.shape == (2, 3, seq, 8)
    close(got, jref.mlstm_scan_ref(qj, kj, vj, fj, ij, chunk=chunk,
                                   normalize=normalize))
    close(got, pallas_mlstm_scan(qj, kj, vj, fj, ij, chunk=chunk,
                                 normalize=normalize, interpret=True),
          **PALLAS_TOL)
    out, state = ref.mlstm_scan_state_ref(q, k, v, f, i, chunk=chunk,
                                          normalize=normalize)
    assert torch.equal(out, got)
    assert state["S"].shape == (2, 3, 16, 8) and state["m"].shape == (2, 3)


def test_mlstm_scan_ref_bfloat16():
    """The reference's bf16 case (SSD, chunk 8): bf16 in, bf16 out."""
    (q, _), (k, _), (v, _), (f, fj), _ = gla_inputs(1, 32, 2, 8, 8, 11, False,
                                                    layout="bhsd")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    as_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    got = ref.mlstm_scan_ref(qb, kb, vb, f, None, chunk=8, normalize=False)
    assert got.dtype == torch.bfloat16
    want = jref.mlstm_scan_ref(as_j(qb), as_j(kb), as_j(vb), fj, None,
                               chunk=8, normalize=False)
    close(got, want, **BF16_TOL)
    close(got, pallas_mlstm_scan(as_j(qb), as_j(kb), as_j(vb), fj, None,
                                 chunk=8, normalize=False, interpret=True),
          rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
def test_bshd_adapter_and_cpu_dispatch(normalize):
    """``ops.mlstm_scan`` on CPU tensors is the plain version (no launch
    counted) and agrees with the reference's ``ops.mlstm_scan`` (its
    oracle off the TPU); ``mlstm_scan_bshd`` on (B, S, H, d) equals
    gated_linear_attention itself, output and state, as does
    ``ops.PLAIN.mlstm_scan_bshd``."""
    (q, qj), (k, kj), (v, vj), (f, fj), (i, ij) = gla_inputs(
        2, 45, 3, 16, 8, 12, normalize)
    before = dict(ops.LAUNCHES)
    want, wstate = S.gated_linear_attention(q, k, v, f, i, chunk=16,
                                            normalize=normalize)
    for fn in (ops.mlstm_scan_bshd, ops.PLAIN.mlstm_scan_bshd):
        got, state = fn(q, k, v, f, i, chunk=16, normalize=normalize)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for name in wstate:
            torch.testing.assert_close(state[name], wstate[name], rtol=0,
                                       atol=0)
    t = lambda x: None if x is None else x.transpose(1, 2)
    out, _ = ops.mlstm_scan(t(q), t(k), t(v), t(f), t(i), chunk=16,
                            normalize=normalize)
    torch.testing.assert_close(out, t(want), rtol=0, atol=0)
    jt = lambda x: None if x is None else jnp.swapaxes(x, 1, 2)
    close(out, jops.mlstm_scan(jt(qj), jt(kj), jt(vj), jt(fj), jt(ij),
                               chunk=16, normalize=normalize))
    assert ops.LAUNCHES == before


def test_kernel_binding_refuses_cpu_tensors():
    """The binding launches or raises: a CPU tensor never reaches it
    quietly (``ops`` routes CPU tensors to the plain version)."""
    (q, _), (k, _), (v, _), (f, _), (i, _) = gla_inputs(1, 8, 2, 4, 4, 13,
                                                        True, layout="bhsd")
    with pytest.raises(ValueError, match="CUDA device"):
        kmlstm.mlstm_scan(q, k, v, f, i, chunk=4)


# ---------------------------------------------------------------------------
# The kernel's chunked route (bf16), as a plain-torch mirror of its passes
# ---------------------------------------------------------------------------

def bf16_terms(x, terms):
    """The sum of the first ``terms`` of x's split into bf16 terms (hi =
    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)), in f32: all
    three give x exactly."""
    out, rest = torch.zeros_like(x), x
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out, rest = out + t, rest - t
    return out


def chunked_passes(q, k, v, log_f, log_i=None, *, chunk, normalize,
                   initial_state=None, terms=3):
    """The chunked route's three passes in f32 torch, (B, H, S, d) layout.
    Gate pass: g summed in order from each chunk's start, the row
    stabilizer from a running max of i - g, one walk over the chunks for
    their stabilizers and decays, then the key weights. State pass: the
    state entering every chunk. Output pass: every chunk at once from its
    entering state and its own keys, y = w_inter (q . S_prev) + P V, with
    P and S_prev as the first ``terms`` of their bf16 split (the kernel
    multiplies all three: exact). Returns ``(out in v's type, {S, n, m},
    {"m_enter", "g"})``."""
    B, H, S_, dk = q.shape
    dv = v.shape[3]
    nc = -(-S_ // chunk)
    pad = nc * chunk - S_
    f = torch.nn.functional.pad(log_f.float(), (0, pad)).reshape(
        B, H, nc, chunk)
    i = torch.zeros_like(log_f) if log_i is None else log_i.float()
    i = torch.nn.functional.pad(i, (0, pad), value=float("-inf")).reshape(
        B, H, nc, chunk)
    qc, kc, vc = (torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
                  .reshape(B, H, nc, chunk, -1) for x in (q, k, v))
    # gate pass
    g, run = torch.empty_like(f), torch.zeros(B, H, nc)
    for c in range(chunk):
        run = run + f[..., c]
        g[..., c] = run
    prefix = torch.cummax(i - g, dim=-1).values
    G = g[..., -1]
    L = ((G[..., None] - g) + i).amax(-1)
    m = torch.zeros(B, H) if initial_state is None else \
        initial_state["m"].float()
    enter, decay = [], []
    for j in range(nc):
        enter.append(m)
        m_new = torch.maximum(G[..., j] + m, L[..., j])
        m_new = torch.where(torch.isfinite(m_new), m_new, 0.0)
        decay.append(torch.exp((G[..., j] + m) - m_new))
        m = m_new
    m_enter = torch.stack(enter, -1)
    m_next = torch.cat([m_enter[..., 1:], m[..., None]], -1)
    M = torch.maximum(g + m_enter[..., None], g + prefix)
    M = torch.where(torch.isfinite(M), M, 0.0)
    if not normalize:
        M = torch.zeros_like(M)
    w = torch.exp(((G[..., None] - g) + i) - m_next[..., None])
    # state pass
    if initial_state is None:
        Sm, nm = torch.zeros(B, H, dk, dv), torch.zeros(B, H, dk)
    else:
        Sm, nm = initial_state["S"].float(), initial_state["n"].float()
    S_in, n_in = [], []
    for j in range(nc):
        S_in.append(Sm)
        n_in.append(nm)
        wj, kj = w[:, :, j], kc[:, :, j]
        Sm = decay[j][..., None, None] * Sm + torch.einsum(
            "bhc,bhcd,bhce->bhde", wj, kj, vc[:, :, j])
        nm = decay[j][..., None] * nm + torch.einsum("bhc,bhcd->bhd", wj, kj)
    S_in, n_in = torch.stack(S_in, 2), torch.stack(n_in, 2)
    # output pass
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    w_inter = torch.exp((g + m_enter[..., None]) - M)
    weight = torch.where(causal, torch.exp(
        ((g[..., :, None] - g[..., None, :]) + i[..., None, :])
        - M[..., None]), 0.0)
    P = torch.einsum("bhjcd,bhjed->bhjce", qc, kc) * weight
    y = w_inter[..., None] * torch.einsum(
        "bhjcd,bhjde->bhjce", qc, bf16_terms(S_in, terms)) \
        + torch.einsum("bhjce,bhjed->bhjcd", bf16_terms(P, terms), vc)
    if normalize:
        nrm = P.sum(-1) + w_inter * torch.einsum("bhjcd,bhjd->bhjc", qc, n_in)
        y = y / torch.maximum(nrm.abs(), torch.exp(-M))[..., None]
    out = y.reshape(B, H, nc * chunk, dv)[:, :, :S_].to(v.dtype)
    return out, {"S": Sm, "n": nm, "m": m}, {"m_enter": m_enter, "g": g}


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
@pytest.mark.parametrize("seq,chunk", [(64, 64), (40, 64), (150, 64),
                                       (200, 128)])
def test_chunked_passes_match_plain_and_reference(seq, chunk, normalize,
                                                  init):
    """The mirror of the chunked route, S a whole chunk, under one chunk
    and ragged, from zeros and from an initial state: output and final
    state against the port's plain version and the reference's oracle
    (2e-5), and the output against the reference's ``mlstm_scan_ref``."""
    (q, qj), (k, kj), (v, vj), (f, fj), (i, ij) = gla_inputs(
        2, seq, 3, 16, 8, seq + chunk + 7 * init, normalize, layout="bhsd")
    st, jst = state_pair(2, 3, 16, 8, seq) if init else (None, None)
    out, state, _ = chunked_passes(q, k, v, f, i, chunk=chunk,
                                   normalize=normalize, initial_state=st)
    want, wstate = ref.mlstm_scan_state_ref(q, k, v, f, i, chunk=chunk,
                                            normalize=normalize,
                                            initial_state=st)
    close(out, want.numpy())
    close_state(state, {n: t.numpy() for n, t in wstate.items()})
    sw = lambda x: None if x is None else jnp.swapaxes(x, 1, 2)
    jout, jstate = JS.gated_linear_attention(
        sw(qj), sw(kj), sw(vj), sw(fj), sw(ij), chunk=chunk,
        normalize=normalize, initial_state=jst)
    close(out, sw(jout))
    close_state(state, jstate)
    if not init:
        close(out, jref.mlstm_scan_ref(qj, kj, vj, fj, ij, chunk=chunk,
                                       normalize=normalize))


@pytest.mark.parametrize("normalize", [True, False], ids=["mlstm", "ssd"])
def test_chunked_passes_bfloat16(normalize):
    """bf16 q, k, v (the chunked route's inputs): the mirror, computing
    in f32 from the exact bf16 values and rounding once, within one bf16
    ulp of the plain version; the f32 state within 2e-5."""
    (q, _), (k, _), (v, _), (f, _), (i, _) = gla_inputs(
        1, 130, 2, 16, 64, 41, normalize, layout="bhsd")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    out, state, _ = chunked_passes(qb, kb, vb, f, i, chunk=64,
                                   normalize=normalize)
    want, wstate = ref.mlstm_scan_state_ref(qb, kb, vb, f, i, chunk=64,
                                            normalize=normalize)
    assert out.dtype == torch.bfloat16
    close(out, want.float().numpy(), **BF16_TOL)
    close_state(state, {n: t.numpy() for n, t in wstate.items()})


@pytest.mark.parametrize("seq,chunk", [(256, 64), (300, 128), (70, 64)])
def test_chunked_passes_ssd_state_stabilizer_is_zero(seq, chunk):
    """The SSD form's m stays exactly 0: g summed in order is
    non-increasing for log f <= 0, so every G - g_c <= 0 and no chunk
    stabilizer leaves 0, as in the oracle."""
    (q, _), (k, _), (v, _), (f, _), _ = gla_inputs(
        2, seq, 3, 16, 8, seq, False, layout="bhsd")
    _, state, gates = chunked_passes(q, k, v, f, None, chunk=chunk,
                                     normalize=False)
    assert torch.equal(state["m"], torch.zeros(2, 3))
    assert torch.equal(gates["m_enter"], torch.zeros_like(gates["m_enter"]))
    g = gates["g"]
    assert bool((g[..., 1:] <= g[..., :-1]).all())
    assert bool((g[..., -1:] - g <= 0).all())


def cancel_inputs(part, seed=0):
    """bf16 inputs (torch) on which the output needs all three bf16 terms
    of an f32 operand, as ``chip_smoke.scan_cancel_inputs`` makes them on
    the card: ``"P"``, normalized, one chunk of 256 from zeros, keys in
    pairs with equal k, opposite v and weights 2**-6 apart (P V a
    difference of near-equal terms); ``"S"``, SSD over two chunks from an
    initial state with rows in pairs, S_2d+1 = -(1 + 2**-6) S_2d, q equal
    in each pair and v 2**-20 small (q . S_prev such a difference).
    Returns (q, k, v, log f, log i, state, chunk, normalize)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    rep2 = lambda a, axis: np.repeat(a, 2, axis=axis)
    bf = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(torch.bfloat16)
    logsig = lambda a: -np.logaddexp(0.0, -a).astype(np.float32)
    d = np.float32(2.0 ** -6)
    if part == "P":
        B, H, S_, dk, dv = 1, 4, 256, 64, 128
        q = n(B, H, S_, dk)
        k = rep2(n(B, H, S_ // 2, dk) * np.float32(dk ** -0.5), 2)
        v = rep2(n(B, H, S_ // 2, dv), 2)
        v[:, :, 1::2] *= -1
        f = logsig(n(B, H, S_) + 4)
        i = rep2(n(B, H, S_ // 2) * np.float32(0.5), 2)
        i[..., 1::2] += f[..., 1::2] + d
        return (bf(q), bf(k), bf(v), torch.as_tensor(f), torch.as_tensor(i),
                None, 256, True)
    B, H, S_, dk, dv = 1, 4, 300, 128, 128
    q = rep2(n(B, H, S_, dk // 2), 3)
    k = n(B, H, S_, dk) * np.float32(dk ** -0.5)
    v = n(B, H, S_, dv) * np.float32(2.0 ** -20)
    f = logsig(n(B, H, S_) + 4)
    S0 = rep2(n(B, H, dk // 2, dv), 2)
    S0[:, :, 1::2] *= -(1 + d)
    state = {"S": torch.as_tensor(S0), "n": torch.zeros(B, H, dk),
             "m": torch.zeros(B, H)}
    return bf(q), bf(k), bf(v), torch.as_tensor(f), None, state, 256, False


def err_over_limit(got, want):
    """The largest |got - want| / (atol + rtol |want|) over the output and
    the final state, at the card checks' tolerances (rtol 2**-7 for a
    bf16 output, 1e-4 for the f32 state, atol 2e-5 x max(1, max
    |want|)): at most 1 holds."""
    worst = 0.0
    for a, b in zip((got[0], *got[1].values()), (want[0], *want[1].values())):
        rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-4
        a, b = a.float(), b.float()
        lim = 2e-5 * max(1.0, float(b.abs().max())) + rtol * b.abs()
        worst = max(worst, float(((a - b).abs() / lim).max()))
    return worst


@pytest.mark.parametrize("part", ["P", "S"])
def test_cancelling_inputs_need_all_three_bf16_terms(part):
    """On the card checks' cancelling inputs the mirror with all three
    bf16 terms of P and of the entering state holds to the port's plain
    version and to the reference's oracle within the card tolerances; with
    one term of the part under test it misses them several times over,
    so the card checks would catch a kernel that drops a term."""
    q, k, v, f, i, st, chunk, nz = cancel_inputs(part)
    want = ref.mlstm_scan_state_ref(q, k, v, f, i, chunk=chunk, normalize=nz,
                                    initial_state=st)
    three = chunked_passes(q, k, v, f, i, chunk=chunk, normalize=nz,
                           initial_state=st)[:2]
    one = chunked_passes(q, k, v, f, i, chunk=chunk, normalize=nz,
                         initial_state=st, terms=1)[:2]
    assert err_over_limit(three, want) <= 1.0
    assert err_over_limit(one, want) > 4.0
    j = lambda x: None if x is None else jnp.swapaxes(
        jnp.asarray(x.float().numpy()), 1, 2)
    jout, _ = JS.gated_linear_attention(
        j(q), j(k), j(v), j(f), j(i), chunk=chunk, normalize=nz,
        initial_state=None if st is None else
        {n_: jnp.asarray(t.numpy()) for n_, t in st.items()})
    close(three[0], jnp.swapaxes(jout, 1, 2), rtol=2.0 ** -7,
          atol=2e-5 * max(1.0, float(jnp.abs(jout).max())))


def test_three_bf16_terms_hold_an_f32_value():
    """The split the chunked route multiplies by: hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid) hold every f32 x exactly (8
    bits of the significand a term), where one term keeps 2**-9 of it."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor((rng.standard_normal(100_000)
                         * 10.0 ** rng.integers(-20, 20, 100_000))
                        .astype(np.float32))
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    assert float(((hi.double() - x.double()).abs() / x.double().abs())
                 .max()) > 2.0 ** -10


@pytest.mark.parametrize("dtype,dk,dv,chunk,describable,want", [
    (torch.bfloat16, 384, 384, 256, True, "wgmma"),    # xLSTM-125M's heads
    (torch.bfloat16, 16, 64, 256, True, "wgmma"),      # Hymba-1.5B's heads
    (torch.bfloat16, 512, 64, 128, True, "wgmma"),
    (torch.bfloat16, 72, 320, 64, True, "wgmma"),
    (torch.float32, 384, 384, 256, True, "simple"),
    (torch.float32, 16, 64, 256, True, "simple"),
    (torch.bfloat16, 20, 70, 64, True, "simple"),
    (torch.bfloat16, 1, 1, 256, True, "simple"),
    (torch.bfloat16, 16, 65, 128, True, "simple"),
    (torch.bfloat16, 16, 64, 8, True, "simple"),
    (torch.bfloat16, 16, 64, 96, True, "simple"),
    (torch.bfloat16, 384, 384, 256, False, "simple")])
def test_route(dtype, dk, dv, chunk, describable, want):
    """Each serve shape in bf16 takes the chunked route; f32, dk or dv
    off a multiple of 8, a chunk off a multiple of 64 and operands a TMA
    map cannot describe keep the one-block kernel."""
    assert kmlstm.route(dtype, dk, dv, chunk, describable) == want


@pytest.mark.parametrize("arch", ["xlstm-125m", "hymba-1.5b"])
def test_serve_views_are_tma_describable(arch):
    """The blocks hand the scan (B, S, H, d) tensors as transposed views:
    xLSTM's q, k, v from reshaped projections, Hymba's C and B sliced
    from one (B, S, 2, H, N) projection; in bf16 each is describable in
    place, so the serve path takes the chunked route without a copy."""
    from repro_torch.kernels import tma
    cfg = get_config(arch)
    B, S_, H = 2, 64, cfg.num_heads
    t = lambda x: x.transpose(1, 2)
    bf = torch.bfloat16
    if arch == "xlstm-125m":
        dh = cfg.ssm_expand * cfg.d_model // H
        q = torch.zeros(B, S_, H * dh, dtype=bf).reshape(B, S_, H, dh)
        views = [q, q.clone(), q.clone()]
        dk = dv = dh
    else:
        N, dv = cfg.ssm_state, cfg.d_model // H
        bc = torch.zeros(B, S_, 2 * H * N, dtype=bf).reshape(B, S_, 2, H, N)
        views = [bc[:, :, 1], bc[:, :, 0],
                 torch.zeros(B, S_, H * dv, dtype=bf).reshape(B, S_, H, dv)]
        dk = N
    assert all(tma.tma_describable(t(x)) for x in views)
    assert kmlstm.route(bf, dk, dv, cfg.chunk_size, True) == "wgmma"


def test_workspace():
    """The chunked route's scratch at the two serve shapes, one f32 state
    a chunk: xLSTM-125M's chunk updates (then entering states) are 16 x 8
    x 384 x 384 f32 (75.5 MB), Hymba-1.5B's 100 x 8 x 16 x 64; the rest
    holds n's, the four gate planes and 2 x BH x NC + BH chunk scalars.
    About 4 (dk dv + dk) / chunk + 16 bytes a token and head."""
    nf = kmlstm.workspace(4, 4, 2048, 384, 384, 256)
    assert nf == (16 * 8 * 384 * 384 + 16 * 8 * 384 + 4 * 16 * 8 * 256
                  + 16 * 9 + 16 * 8)
    assert 4 * 16 * 8 * 384 * 384 == 75_497_472
    assert 75e6 < 4 * nf < 77e6
    nf = kmlstm.workspace(4, 25, 2048, 16, 64, 256)
    assert nf == (100 * 8 * 16 * 64 + 100 * 8 * 16 + 4 * 100 * 2048
                  + 100 * 9 + 100 * 8)
    assert kmlstm.workspace(1, 1, 300, 16, 8, 128) == (
        3 * 16 * 8 + 3 * 16 + 4 * 384 + 4 + 3)
    per = lambda dk, dv, c: 4 * (dk * dv + dk) / c + 16
    for shape, c in (((4, 4, 2048, 384, 384), 256), ((1, 4, 32768, 384, 384),
                                                      256)):
        B, H, S_, dk, dv = shape
        assert 4 * kmlstm.workspace(*shape, c) == pytest.approx(
            B * H * S_ * per(dk, dv, c), rel=1e-3)