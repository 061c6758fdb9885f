"""Port parity for the transformer stack: ``repro_torch.configs``,
``models.common``, ``models.layers`` and ``models.transformer`` against
the JAX package's, on the same numpy-seeded inputs and, for whole
models, the same weights carried across by ``params_from_jax``.

Tolerances. Configs, masks, cache layouts and positions are compared
exactly. Float layers run in f32 on both sides and differ only in the
order of f32 sums (einsum, matmul, softmax, mean) and in ``pow`` /
``cos`` / ``rsqrt`` rounding: rtol = atol = 1e-5 on unit-scale values.
The reduced SmolLM's logits (two layers, |logit| up to about 1.5) agreed
to 2e-6 when this was written; they are held to rtol 1e-5 / atol 2e-5,
and cached K/V (after RoPE) to atol 2e-5. The SSM and hybrid stacks
(xLSTM with four layers, three mLSTM and one sLSTM; Hymba) add the
chunked scan's exps and the sLSTM's step-by-step recurrence: their
logits (|logit| up to about 4.5) agreed to 2.6e-5 and are held, with
their caches, to rtol = atol = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.models import common as jcommon
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import common
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-5)


def close(port, other, **tol):
    np.testing.assert_allclose(port.detach().to(torch.float32).numpy(),
                               np.asarray(other, np.float32),
                               **(tol or TOL))


def normals(shape, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    a *= np.float32(scale)
    return torch.as_tensor(a), jnp.asarray(a)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def fields(cfg, flag):
    d = dataclasses.asdict(cfg)
    return d, d.pop(flag)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_fields_match_reference(arch):
    """Every field equal, ``use_kernels`` standing for ``use_pallas``;
    the same for ``reduced()`` and the derived quantities."""
    assert ARCH_IDS == J_ARCH_IDS
    for port, refc in ((get_config(arch), jget(arch)),
                       (get_config(arch).reduced(), jget(arch).reduced()),
                       (get_config(arch, sliding_window=32).reduced(
                           num_layers=1, d_model=128),
                        jget(arch, sliding_window=32).reduced(
                            num_layers=1, d_model=128))):
        pd, pflag = fields(port, "use_kernels")
        rd, rflag = fields(refc, "use_pallas")
        assert pd == rd and pflag == rflag is False
        assert port.resolved_head_dim == refc.resolved_head_dim
        assert port.layer_types == refc.layer_types
        assert port.is_moe == refc.is_moe and \
            port.is_enc_dec == refc.is_enc_dec
        assert port.param_dtype == getattr(torch, refc.param_dtype.name)
        assert common.model_flops_per_token(port) == \
            jcommon.model_flops_per_token(refc)
    assert set(all_configs()) == set(ARCH_IDS)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    x, xj = normals((2, 24, 3, 32), 0)
    pos = np.stack([np.arange(24), np.arange(100, 124)]).astype(np.int32)
    close(L.apply_rope(x, torch.as_tensor(pos), theta),
          JL.apply_rope(xj, jnp.asarray(pos), theta))


def test_sinusoidal_embedding_matches():
    close(L.sinusoidal_embedding(40, 24), JL.sinusoidal_embedding(40, 24))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 7)])
def test_attention_mask_matches(causal, window):
    qp = np.arange(10, 22, dtype=np.int32)[None].repeat(2, 0)
    kp = np.arange(0, 22, dtype=np.int32)[None].repeat(2, 0)
    got = L.attention_mask(torch.as_tensor(qp), torch.as_tensor(kp), causal,
                           window)
    want = JL.attention_mask(jnp.asarray(qp), jnp.asarray(kp), causal, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_dot_product_attention_matches(soft_cap):
    q, qj = normals((2, 12, 6, 16), 1)
    k, kj = normals((2, 20, 3, 16), 2)
    v, vj = normals((2, 20, 3, 16), 3)
    pos = np.arange(20, dtype=np.int32)[None].repeat(2, 0)
    qpos = pos[:, 8:]
    mask = JL.attention_mask(jnp.asarray(qpos), jnp.asarray(pos), True, 6)
    tmask = L.attention_mask(torch.as_tensor(qpos), torch.as_tensor(pos),
                             True, 6)
    close(L.dot_product_attention(q, k, v, tmask[:, None], soft_cap),
          JL.dot_product_attention(qj, kj, vj, mask[:, None], soft_cap))


@pytest.mark.parametrize("window", [0, 9])
def test_chunked_attention_matches(window):
    q, qj = normals((1, 40, 4, 16), 4)
    k, kj = normals((1, 40, 2, 16), 5)
    v, vj = normals((1, 40, 2, 16), 6)
    pos = np.arange(40, dtype=np.int32)[None]
    got = L.chunked_attention(q, k, v, torch.as_tensor(pos), causal=True,
                              window=window, q_chunk=16)
    close(got, JL.chunked_attention(qj, kj, vj, jnp.asarray(pos),
                                    causal=True, window=window, q_chunk=16))
    mask = L.attention_mask(torch.as_tensor(pos), torch.as_tensor(pos), True,
                            window)[:, None]
    close(got, L.dot_product_attention(q, k, v, mask))


@pytest.mark.parametrize("window", [0, 16, 64])
def test_build_kv_cache_matches(window):
    """Full (window 0 or >= S, zero-padded) and ring (window < S) layouts:
    exact."""
    k, kj = normals((2, 40, 2, 8), 7)
    v, vj = normals((2, 40, 2, 8), 8)
    pos = np.arange(40, dtype=np.int32)[None].repeat(2, 0)
    got = L.build_kv_cache(k, v, torch.as_tensor(pos), window)
    want = JL.build_kv_cache(kj, vj, jnp.asarray(pos), window)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    if window == 16:
        assert sorted(got["pos"].tolist()) == list(range(24, 40))


@pytest.mark.parametrize("window", [0, 16])
def test_cache_attend_matches(window):
    """Insert one decode step's K/V (at the ring slot when windowed) and
    attend; the port updates the cache in place."""
    cfg = get_config("smollm-360m").reduced()
    k, kj = normals((2, 30, 2, 16), 9)
    v, vj = normals((2, 30, 2, 16), 10)
    pos = np.arange(30, dtype=np.int32)[None].repeat(2, 0)
    cache = L.build_kv_cache(k, v, torch.as_tensor(pos), window)
    jcache = JL.build_kv_cache(kj, vj, jnp.asarray(pos), window)
    if not window:
        cache = {"k": torch.nn.functional.pad(cache["k"], (0, 0, 0, 0, 0, 4)),
                 "v": torch.nn.functional.pad(cache["v"], (0, 0, 0, 0, 0, 4)),
                 "pos": torch.nn.functional.pad(cache["pos"], (0, 4),
                                                value=-1)}
        jcache = {"k": jnp.pad(jcache["k"], ((0, 0), (0, 4), (0, 0), (0, 0))),
                  "v": jnp.pad(jcache["v"], ((0, 0), (0, 4), (0, 0), (0, 0))),
                  "pos": jnp.pad(jcache["pos"], (0, 4), constant_values=-1)}
    q, qj = normals((2, 1, 4, 16), 11)
    nk, nkj = normals((2, 1, 2, 16), 12)
    nv, nvj = normals((2, 1, 2, 16), 13)
    qpos = np.full((2, 1), 30, np.int32)
    o, newc = L.cache_attend(cfg, q, cache, torch.as_tensor(qpos), window,
                             nk, nv)
    jo, jnewc = JL.cache_attend(cfg, qj, jcache, jnp.asarray(qpos), window,
                                nkj, nvj)
    close(o, jo)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(newc[name].numpy(),
                                      np.asarray(jnewc[name]))
    assert newc["k"] is cache["k"]


def test_norms_match_and_rmsnorm_roundings():
    """The model's RMSNorm and LayerNorm match the reference's. In f32 the
    model's RMSNorm (rsqrt cast, then x·r·scale) and the kernels' oracle
    (x·r cast, then ·scale) agree to an ulp or two; in bf16 the model
    rounds three times (r, x·r, ·scale) and the oracle twice, so they
    differ by up to two bf16 ulps of the output (2**-6 relative at the
    bottom of a binade). The port's model RMSNorm and the reference's
    round at the same places: within one bf16 ulp (2**-7)."""
    x, xj = normals((5, 96), 14, 3.0)
    s, sj = normals((96,), 15)
    b, bj = normals((96,), 16)
    close(L.rmsnorm(x, s), JL.rmsnorm(xj, sj))
    close(L.layernorm(x, s, b), JL.layernorm(xj, sj, bj))
    close(L.rmsnorm(x, s), ref.rmsnorm_ref(x, s).numpy(), rtol=1e-6,
          atol=1e-6)
    xb, sb = x.to(torch.bfloat16), s.to(torch.bfloat16)
    model, oracle = L.rmsnorm(xb, sb), ref.rmsnorm_ref(xb, sb)
    assert model.dtype == oracle.dtype == torch.bfloat16
    np.testing.assert_allclose(model.float().numpy(), oracle.float().numpy(),
                               rtol=2.0 ** -6, atol=1e-6)
    jmodel = JL.rmsnorm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                        jnp.asarray(sb.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_allclose(model.float().numpy(),
                               np.asarray(jmodel, np.float32),
                               rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("arch", ["smollm-360m", "starcoder2-15b"])
def test_mlp_matches(arch):
    """SwiGLU (SmolLM) and tanh-GELU (StarCoder2) MLPs."""
    cfg = get_config(arch).reduced(d_model=64)
    jcfg = jget(arch).reduced(d_model=64)
    jp = JL.mlp_params(jcfg, jax.random.PRNGKey(3))
    p = {n: torch.as_tensor(np.array(a)) for n, a in jp.items()}
    x, xj = normals((2, 5, cfg.d_model), 17)
    close(L.mlp(cfg, p, x), JL.mlp(jcfg, jp, xj))


# ---------------------------------------------------------------------------
# Whole models on carried weights
# ---------------------------------------------------------------------------

VARIANTS = {           # get_config overrides, then reduced(); kv override
    "smollm": ({}, None),
    "smollm_gqa": ({}, 2),
    "smollm_window16": ({"sliding_window": 16}, 2),
}


def model_pair(variant, dtype="float32"):
    over, kv = VARIANTS[variant]
    extra = {"dtype": dtype} if dtype != "float32" else {}
    if kv is not None:
        extra["num_kv_heads"] = kv
    jcfg = dataclasses.replace(jget("smollm-360m", **over).reduced(), **extra)
    cfg = dataclasses.replace(get_config("smollm-360m", **over).reduced(),
                              **extra)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, T.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp)), jp


def tokens(B, S, seed=0, vocab=512):
    t = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return torch.as_tensor(t), jnp.asarray(t, jnp.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_loss_match_reference(variant):
    cfg, jcfg, p, jp = model_pair(variant)
    t, tj = tokens(2, 32)
    logits, aux = T.forward(cfg, p, t)
    jlogits, _ = JT.forward(jcfg, jp, tj)
    close(logits, jlogits, **LOGIT_TOL)
    assert float(aux) == 0.0
    tgt = np.random.default_rng(1).integers(-1, 512, (2, 32))
    w = np.array([0.25, 0.75], np.float32)
    got, m = T.loss_fn(cfg, p, {"tokens": t, "targets": torch.as_tensor(tgt),
                                "weights": torch.as_tensor(w)})
    want, jm = JT.loss_fn(jcfg, jp, {"tokens": tj,
                                     "targets": jnp.asarray(tgt, jnp.int32),
                                     "weights": jnp.asarray(w)})
    close(got, want)
    assert float(m["tokens"]) == float(jm["tokens"])


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_reference(variant, kernels):
    """Prefill, grow_cache and 8 teacher-forced decode steps. With kernels
    on, the port routes through ``kernels.ops`` (on the CPU: the plain
    versions) and the reference through its own ops as ``flash_fn`` and
    ``swiglu_fn``."""
    cfg, jcfg, p, jp = model_pair(variant)
    cfg = dataclasses.replace(cfg, use_kernels=kernels)
    kw = dict(flash_fn=jops.flash_attention_bshd,
              swiglu_fn=jops.swiglu) if kernels else {}
    t, tj = tokens(2, 32)
    logits, cache, _ = T.prefill(cfg, p, t)
    jlogits, jcache, _ = JT.prefill(jcfg, jp, tj, **kw)
    close(logits, jlogits, **LOGIT_TOL)
    assert logits.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_array_equal(cache["kv"]["pos"].numpy(),
                                  np.asarray(jcache["kv"]["pos"]))
    close(cache["kv"]["k"], jcache["kv"]["k"], rtol=1e-5, atol=2e-5)
    cache = T.grow_cache(cfg, cache, 8)
    jcache = JT.grow_cache(jcfg, jcache, 8)
    assert cache["kv"]["k"].shape == jcache["kv"]["k"].shape
    for step in range(8):
        feed, jfeed = tokens(2, 1, seed=100 + step)
        logits, cache = T.decode_step(cfg, p, feed, cache, 32 + step)
        jlogits, jcache = JT.decode_step(jcfg, jp, jfeed, jcache, 32 + step,
                                         **kw)
        close(logits, jlogits, **LOGIT_TOL)
    np.testing.assert_array_equal(cache["kv"]["pos"].numpy(),
                                  np.asarray(jcache["kv"]["pos"]))
    close(cache["kv"]["v"], jcache["kv"]["v"], rtol=1e-5, atol=2e-5)


def test_kernel_routing_counts_each_op():
    """With ``use_kernels`` every norm, MLP and prefill attention goes
    through the namespace: 2L + 1 norms and L SwiGLUs a pass, L flash
    attentions in prefill and none in decode; a caller's own ``flash_fn``
    wins over the namespace's."""
    cfg, _, p, _ = model_pair("smollm_gqa")
    calls = {"rmsnorm": 0, "swiglu": 0, "flash_attention_bshd": 0}

    class Spy:
        def __getattr__(self, name):
            fn = getattr(ops.PLAIN, name)

            def wrapped(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return wrapped

    kcfg = dataclasses.replace(cfg, use_kernels=True)
    t, _ = tokens(2, 16)
    _, cache, _ = T.prefill(kcfg, p, t, kernels=Spy())
    n = cfg.num_layers
    assert calls == {"rmsnorm": 2 * n + 1, "swiglu": n,
                     "flash_attention_bshd": n}
    cache = T.grow_cache(kcfg, cache, 2)
    T.decode_step(kcfg, p, t[:, :1], cache, 16, kernels=Spy())
    assert calls == {"rmsnorm": 2 * (2 * n + 1), "swiglu": 2 * n,
                     "flash_attention_bshd": n}
    mine = []
    T.prefill(kcfg, p, t, kernels=Spy(),
              flash_fn=lambda *a, **k: mine.append(1) or
              ops.PLAIN.flash_attention_bshd(*a, **k))
    assert len(mine) == n and calls["flash_attention_bshd"] == n
    plain = T.prefill(cfg, p, t)[0]
    torch.testing.assert_close(T.prefill(kcfg, p, t)[0], plain, rtol=1e-5,
                               atol=2e-5)


def test_params_from_jax_keeps_layout_and_dtypes():
    cfg, jcfg, p, jp = model_pair("smollm_gqa", dtype="bfloat16")
    flat = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat:
        node = p
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.bfloat16
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert p["layers"]["attn"]["wq"].shape[0] == cfg.num_layers
    mine = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert common.count_params(mine) == jcommon.count_params(jp)
    assert T.tree_map(lambda a: (tuple(a.shape), a.dtype), mine) == \
        T.tree_map(lambda a: (tuple(a.shape), a.dtype), p)
    with pytest.raises(ValueError, match="encoder"):
        T.params_from_jax({**jax.tree_util.tree_map(np.asarray, jp),
                           "encoder": {}})


def test_init_decode_cache_matches_reference():
    for over in ({}, {"sliding_window": 16}):
        cfg = get_config("smollm-360m", **over).reduced()
        jcfg = jget("smollm-360m", **over).reduced()
        got = T.init_decode_cache(cfg, 3, 40)
        want = JT.init_decode_cache(jcfg, 3, 40)
        for name in ("k", "v", "pos"):
            np.testing.assert_array_equal(got["kv"][name].numpy(),
                                          np.asarray(want["kv"][name]))


@pytest.mark.parametrize("arch,over", [
    ("qwen2-moe-a2.7b", {}), ("internvl2-26b", {}),
    ("llama4-scout-17b-a16e", {}), ("whisper-large-v3", {}),
    ("smollm-360m", {"remat": True})])
def test_families_init_like_the_reference(arch, over):
    """MoE (Qwen2-MoE, Llama 4 Scout), the vision frontend (InternVL2),
    the encoder-decoder (Whisper) and remat build: the port's own
    ``init_params`` tree has the reference's names, shapes and dtypes,
    and as many parameters."""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(arch, **over).reduced(),
                                  dtype=dtype)
        jcfg = dataclasses.replace(jget(arch, **over).reduced(), dtype=dtype)
        mine = T.init_params(cfg, torch.Generator().manual_seed(0))
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        want = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            want["/".join(str(k.key) for k in path)] = (leaf.shape,
                                                        leaf.dtype.name)
        got = {}

        def walk(node, prefix):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{prefix}/{k}" if prefix else k)
            else:
                got[prefix] = (tuple(node.shape),
                               str(node.dtype).replace("torch.", ""))
        walk(mine, "")
        assert got == want
        assert common.count_params(mine) == jcommon.count_params(jp)


# ---------------------------------------------------------------------------
# The SSM and hybrid stacks on carried weights
# ---------------------------------------------------------------------------

SSM_TOL = dict(rtol=1e-4, atol=1e-4)
# variant: (arch, layers, prompt length). xLSTM at 4 layers is a list
# stack with an sLSTM at position 3; at 2 layers two mLSTMs, stacked.
# Hymba's window is 64 in the reduced config: its prompts are longer.
SSM_VARIANTS = {"xlstm4": ("xlstm-125m", 4, 40),
                "xlstm2": ("xlstm-125m", 2, 40),
                "hymba": ("hymba-1.5b", 2, 80)}


def ssm_pair(variant, dtype="float32"):
    arch, layers, _ = SSM_VARIANTS[variant]
    jcfg = dataclasses.replace(jget(arch).reduced(num_layers=layers),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(num_layers=layers),
                              dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, T.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp)), jp


def close_tree(port, other, path=""):
    """Every leaf of a cache tree (lists and dicts) against the
    reference's: positions exact, values within SSM_TOL."""
    if isinstance(other, (list, tuple)):
        assert isinstance(port, list) and len(port) == len(other), path
        for i, (a, b) in enumerate(zip(port, other)):
            close_tree(a, b, f"{path}[{i}]")
    elif isinstance(other, dict):
        assert sorted(port) == sorted(other), path
        for k in other:
            close_tree(port[k], other[k], f"{path}.{k}")
    elif path.endswith("pos"):
        np.testing.assert_array_equal(port.numpy(), np.asarray(other), path)
    else:
        assert tuple(port.shape) == other.shape, path
        close(port, other, **SSM_TOL)


@pytest.mark.parametrize("variant", list(SSM_VARIANTS))
def test_ssm_forward_matches_reference(variant):
    cfg, jcfg, p, jp = ssm_pair(variant)
    assert isinstance(p["layers"], list) == (variant == "xlstm4")
    S = SSM_VARIANTS[variant][2]
    t, tj = tokens(2, S)
    logits, aux = T.forward(cfg, p, t)
    close(logits, JT.forward(jcfg, jp, tj)[0], **SSM_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("variant", list(SSM_VARIANTS))
def test_ssm_prefill_and_decode_match_reference(variant, kernels):
    """Prefill (the caches built, Hymba's as a ring past its window),
    grow_cache and 8 teacher-forced decode steps. With kernels on, the
    port routes the scans through ``kernels.ops.mlstm_scan_bshd`` (on the
    CPU its plain version) and the reference its attention and MLP
    through its own ops."""
    cfg, jcfg, p, jp = ssm_pair(variant)
    cfg = dataclasses.replace(cfg, use_kernels=kernels)
    kw = dict(flash_fn=jops.flash_attention_bshd,
              swiglu_fn=jops.swiglu) if kernels else {}
    S = SSM_VARIANTS[variant][2]
    t, tj = tokens(2, S)
    logits, cache, _ = T.prefill(cfg, p, t)
    jlogits, jcache, _ = JT.prefill(jcfg, jp, tj, **kw)
    close(logits, jlogits, **SSM_TOL)
    close_tree(cache, jcache)
    cache = T.grow_cache(cfg, cache, 8)
    jcache = JT.grow_cache(jcfg, jcache, 8)
    close_tree(cache, jcache)
    for step in range(8):
        feed, jfeed = tokens(2, 1, seed=100 + step)
        logits, cache = T.decode_step(cfg, p, feed, cache, S + step)
        jlogits, jcache = JT.decode_step(jcfg, jp, jfeed, jcache, S + step,
                                         **kw)
        close(logits, jlogits, **SSM_TOL)
    close_tree(cache, jcache)


@pytest.mark.parametrize("variant", list(SSM_VARIANTS))
def test_ssm_init_decode_cache_matches_reference(variant):
    """Zeros (and -1 positions) of the reference's shapes and dtypes, a
    list for the mixed xLSTM stack, stacked (L, ...) otherwise."""
    cfg, jcfg, _, _ = ssm_pair(variant, dtype="bfloat16")
    got = T.init_decode_cache(cfg, 3, 40)
    want = JT.init_decode_cache(jcfg, 3, 40)

    def same(a, b, path=""):
        if isinstance(b, (list, dict)):
            assert type(a) is type(b) and len(a) == len(b), path
            items = b.items() if isinstance(b, dict) else enumerate(b)
            for k, v in items:
                same(a[k], v, f"{path}/{k}")
            return
        assert a.dtype == getattr(torch, b.dtype.name), path
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), path)
    same(got, want)


@pytest.mark.parametrize("variant", ["xlstm4", "hymba"])
def test_params_from_jax_carries_list_and_stacked_trees(variant):
    """bf16 leaves copied exactly into the reference's nesting: per-layer
    dicts in a list for xLSTM's mixed stack, stacked (L, ...) for
    Hymba; the port's own init draws the same tree; an MoE stack carries
    across too."""
    cfg, jcfg, p, jp = ssm_pair(variant, dtype="bfloat16")
    flat = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat:
        node = p
        for key in path:
            node = node[key.idx if hasattr(key, "idx") else key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.bfloat16
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    mine = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert common.count_params(mine) == jcommon.count_params(jp)
    assert T.tree_map(lambda a: (tuple(a.shape), a.dtype), mine) == \
        T.tree_map(lambda a: (tuple(a.shape), a.dtype), p)
    if variant == "xlstm4":
        assert [sorted(layer) == sorted(T.LAYER_KEYS[t]) for layer, t in
                zip(p["layers"], cfg.layer_types)] == [True] * 4
    else:
        assert p["layers"]["mamba"]["w_bc"].shape[0] == cfg.num_layers
    moe = get_config("qwen2-moe-a2.7b").reduced()
    jmoe = JT.init_params(jget("qwen2-moe-a2.7b").reduced(),
                          jax.random.PRNGKey(0))
    carried = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jmoe))
    assert moe.layer_types[0] == "moe"
    assert sorted(carried["layers"]) == sorted(T.LAYER_KEYS["moe"])
    for name, leaf in jmoe["layers"]["moe"].items():
        if name != "shared":
            np.testing.assert_array_equal(
                carried["layers"]["moe"][name].numpy(), np.asarray(leaf))
    assert carried["layers"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("variant", list(SSM_VARIANTS))
def test_ssm_kernel_routing_counts_each_op(variant):
    """With ``use_kernels`` the prefill scans go through the namespace
    (one per mLSTM layer or Hymba block) and decode adds none; Hymba's
    norms, MLPs and attention take the dense stack's routes, while the
    xLSTM blocks' own norms stay plain (only ``final_norm`` routes)."""
    cfg, _, p, _ = ssm_pair(variant)
    names = ("rmsnorm", "swiglu", "flash_attention_bshd", "mlstm_scan_bshd")
    calls = dict.fromkeys(names, 0)

    class Spy:
        def __getattr__(self, name):
            fn = getattr(ops.PLAIN, name)

            def wrapped(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return wrapped

    kcfg = dataclasses.replace(cfg, use_kernels=True)
    t, _ = tokens(2, SSM_VARIANTS[variant][2])
    _, cache, _ = T.prefill(kcfg, p, t, kernels=Spy())
    cache = T.grow_cache(kcfg, cache, 2)
    T.decode_step(kcfg, p, t[:, :1], cache, t.shape[1], kernels=Spy())
    n = cfg.num_layers
    scans = sum(x in ("mlstm", "hymba") for x in cfg.layer_types)
    if variant == "hymba":
        want = {"rmsnorm": 2 * (2 * n + 1), "swiglu": 2 * n,
                "flash_attention_bshd": n, "mlstm_scan_bshd": n}
    else:
        want = {"rmsnorm": 2, "swiglu": 0, "flash_attention_bshd": 0,
                "mlstm_scan_bshd": scans}
    assert calls == want
