"""Port parity for the model families that take the MoE layer, the stub
frontends and the encoder: Qwen1.5-MoE-A2.7B and Llama-4-Scout (MoE; Llama
4 also with an early-fusion vision prefix), InternVL2-26B (vision
prefix) and Whisper-large-v3 (encoder-decoder with cross-attention), and
``remat``, against the JAX package on its reduced configs, weights
carried across by ``params_from_jax``, inputs numpy-seeded.

Tolerances. In f32 both sides differ only by the order of f32 sums:
logits within ``LOGIT_TOL`` (rtol 1e-5, atol 2e-5, as the dense stack's
in tests/test_torch_models.py), caches within rtol = atol = 1e-5 on
unit-scale values, the MoE auxiliary loss within 1e-6. MoE routing is
compared through the logits: a flipped expert would move them far past
the tolerance. In bf16 (``BF16_TOL``) each side rounds every product to
bf16, and an f32 sum in another order can move a rounding by one bf16
ulp (2**-8 relative) that later layers carry; the logits are held to
3 % of the largest |logit| (Whisper's agreed to 0.7 %, InternVL2's to
1.1 % when this was written). The logits cannot tell the frontends'
f32 promotion from bf16 arithmetic, so the projector's output and
Whisper's encoder output are held in f32 at TOL on unit-scale values
(they agreed to 6e-7; in bf16 they would be 2**-8 off and of the wrong
type).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = 0.03        # of the largest |logit|
B, S = 2, 24
# family: (arch, patches given explicitly to an early-fusion config)
FAMILIES = {"qwen_moe": ("qwen2-moe-a2.7b", 0),
            "llama4": ("llama4-scout-17b-a16e", 0),
            "llama4_fused": ("llama4-scout-17b-a16e", 6),
            "internvl2": ("internvl2-26b", 0),
            "whisper": ("whisper-large-v3", 0)}


def close(port, other, **tol):
    np.testing.assert_allclose(port.detach().to(torch.float32).numpy(),
                               np.asarray(other, np.float32),
                               **(tol or TOL))


def carry(jp):
    return T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def family_pair(family, dtype="float32", **over):
    arch = FAMILIES[family][0]
    jcfg = dataclasses.replace(jget(arch).reduced(), dtype=dtype, **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                              **over)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, carry(jp), jp


def make_inputs(cfg, seed=0, patches=0):
    """Tokens, targets and the extras, drawn with numpy: the port's
    tensors, the reference's arrays and the number of prefix positions
    (a VLM's ``frontend_seq``, or ``patches`` given explicitly)."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
              "targets": rng.integers(-1, cfg.vocab_size, (B, S))}
    patches = patches or (cfg.frontend_seq if cfg.family == "vlm" else 0)
    if patches:
        arrays["patch_embeds"] = rng.standard_normal(
            (B, patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.is_enc_dec:
        arrays["frames"] = rng.standard_normal(
            (B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    port = {k: torch.as_tensor(v) for k, v in arrays.items()}
    ref = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
           for k, v in arrays.items()}
    return port, ref, patches


def extras_of(batch):
    return {k: batch[k] for k in ("patch_embeds", "frames") if k in batch}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_and_loss_match_reference(family):
    cfg, jcfg, p, jp = family_pair(family)
    batch, jbatch, _ = make_inputs(cfg, patches=FAMILIES[family][1])
    logits, aux = T.forward(cfg, p, batch["tokens"], extras_of(batch))
    jlogits, jaux = JT.forward(jcfg, jp, jbatch["tokens"], extras_of(jbatch))
    assert logits.shape == (B, S, cfg.vocab_size)
    close(logits, jlogits, **LOGIT_TOL)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert (float(aux) > 0) == cfg.is_moe
    w = np.array([0.25, 0.75], np.float32)
    total, m = T.loss_fn(cfg, p, {**batch, "weights": torch.as_tensor(w)})
    jtotal, jm = JT.loss_fn(jcfg, jp, {**jbatch, "weights": jnp.asarray(w)})
    close(total, jtotal)
    close(m["loss"], jm["loss"])
    assert abs(float(m["aux_loss"]) - float(jm["aux_loss"])) <= 1e-6
    assert float(m["tokens"]) == float(jm["tokens"])


def unit_close(port, other):
    """A cache leaf against the reference's: positions exact, values
    within TOL on unit-scale values."""
    if np.asarray(other).dtype.kind == "i":
        np.testing.assert_array_equal(port.numpy(), np.asarray(other))
        return
    want = np.asarray(other, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(port.float().numpy() / scale, want / scale,
                               **TOL)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_match_reference(family, kernels):
    """Prefill (with the encoder's memory), grow_cache and 6
    teacher-forced decode steps, whose positions count the vision
    prefix. With kernels on, the port routes through ``kernels.ops`` (on
    the CPU: the plain versions) and the reference through its own ops
    as ``flash_fn`` and ``swiglu_fn``."""
    cfg, jcfg, p, jp = family_pair(family)
    cfg = dataclasses.replace(cfg, use_kernels=kernels)
    kw = dict(flash_fn=jops.flash_attention_bshd,
              swiglu_fn=jops.swiglu) if kernels else {}
    batch, jbatch, n_prefix = make_inputs(cfg, patches=FAMILIES[family][1])
    logits, cache, memory = T.prefill(cfg, p, batch["tokens"],
                                      extras_of(batch))
    jlogits, jcache, jmemory = JT.prefill(jcfg, jp, jbatch["tokens"],
                                          extras_of(jbatch), **kw)
    close(logits, jlogits, **LOGIT_TOL)
    assert (memory is None) == (jmemory is None) == (not cfg.is_enc_dec)
    if memory is not None:
        assert memory.dtype == torch.float32
        close(memory, jmemory)
    for name in ("k", "v", "pos"):
        unit_close(cache["kv"][name], jcache["kv"][name])
    assert cache["kv"]["k"].shape[2] == S + n_prefix
    cache = T.grow_cache(cfg, cache, 6)
    jcache = JT.grow_cache(jcfg, jcache, 6)
    for step in range(6):
        feed = np.random.default_rng(100 + step).integers(
            0, cfg.vocab_size, (B, 1))
        index = S + n_prefix + step
        logits, cache = T.decode_step(cfg, p, torch.as_tensor(feed), cache,
                                      index, memory=memory)
        jlogits, jcache = JT.decode_step(jcfg, jp, jnp.asarray(feed,
                                                              jnp.int32),
                                         jcache, index, memory=jmemory, **kw)
        close(logits, jlogits, **LOGIT_TOL)
    for name in ("k", "v", "pos"):
        unit_close(cache["kv"][name], jcache["kv"][name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_consistency(arch):
    """The reference's check (tests/test_arch_smoke.py) on the port:
    prefill's last logits equal the forward's at S - 2, and one decode
    step's equal the forward's last (the vision prefix shifts positions,
    so a VLM compares decode only; MoE with a no-drop capacity, since
    finite capacity drops different tokens from different populations)."""
    cfg = get_config(arch).reduced()
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    p = T.init_params(cfg, torch.Generator().manual_seed(2))
    batch, _, n_prefix = make_inputs(cfg, seed=2)
    toks, extras = batch["tokens"], extras_of(batch)
    full, _ = T.forward(cfg, p, toks, extras)
    assert bool(torch.isfinite(full).all())
    pre, cache, memory = T.prefill(cfg, p, toks[:, :-1], extras)
    tol = dict(rtol=2e-3, atol=2e-3)
    if cfg.family != "vlm":
        torch.testing.assert_close(pre[:, 0], full[:, -2], **tol)
    cache = T.grow_cache(cfg, cache, 1)
    dec, _ = T.decode_step(cfg, p, toks[:, -1:], cache, S - 1 + n_prefix,
                           memory)
    torch.testing.assert_close(dec[:, 0], full[:, -1], **tol)


@pytest.mark.parametrize("family", ["whisper", "internvl2"])
def test_bf16_matches_reference(family):
    """bf16 weights and f32 stub embeddings: the projector (and Whisper's
    encoder and cross-attention K/V) compute in f32 as ``jnp`` promotes
    them; the decoder stays bf16. Forward, prefill and two decode steps
    within BF16_TOL of the largest |logit|."""
    cfg, jcfg, p, jp = family_pair(family, dtype="bfloat16")
    batch, jbatch, n_prefix = make_inputs(cfg, seed=5, patches=FAMILIES[family][1])
    logits, _ = T.forward(cfg, p, batch["tokens"], extras_of(batch))
    jlogits, _ = JT.forward(jcfg, jp, jbatch["tokens"], extras_of(jbatch))
    assert logits.dtype == torch.bfloat16

    def held(got, want):
        want = np.asarray(want, np.float32)
        top = float(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=BF16_TOL * top)
    held(logits, jlogits)
    pre, cache, memory = T.prefill(cfg, p, batch["tokens"], extras_of(batch))
    jpre, jcache, jmemory = JT.prefill(jcfg, jp, jbatch["tokens"],
                                       extras_of(jbatch))
    held(pre, jpre)
    if cfg.is_enc_dec:
        front = memory
        jfront = jmemory
    else:
        front = T._project_frontend(p, batch["patch_embeds"])
        jfront = JT._project_frontend(jp, jbatch["patch_embeds"])
    assert front.dtype == torch.float32 == getattr(torch, jfront.dtype.name)
    unit_close(front, jfront)
    cache, jcache = T.grow_cache(cfg, cache, 2), JT.grow_cache(jcfg, jcache, 2)
    for step in range(2):
        feed = batch["tokens"][:, step:step + 1]
        index = S + n_prefix + step
        out, cache = T.decode_step(cfg, p, feed, cache, index, memory)
        jout, jcache = JT.decode_step(jcfg, jp, jnp.asarray(feed.numpy(),
                                                           jnp.int32),
                                      jcache, index, jmemory)
        held(out, jout)


def grads_port(cfg, p, batch):
    leaves = {}

    def track(a):
        a = a.detach().clone().requires_grad_(a.is_floating_point())
        leaves[id(a)] = a
        return a
    p = T.tree_map(track, p)
    total, _ = T.loss_fn(cfg, p, batch)
    total.backward()
    return total, T.tree_map(lambda a: a.grad, p)


@pytest.mark.parametrize("family", ["smollm", "whisper"])
def test_remat_gradients_match(family):
    """``remat=True`` recomputes each layer's activations in the backward
    pass: on the CPU its gradients equal those without remat bit for
    bit, and they match ``jax.grad`` of the reference with ``remat=True``
    to LOGIT_TOL on unit-scale gradients."""
    arch = {"smollm": "smollm-360m", "whisper": "whisper-large-v3"}[family]
    jcfg = dataclasses.replace(jget(arch).reduced(), remat=True)
    cfg = get_config(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
    p = carry(jp)
    batch, jbatch, _ = make_inputs(cfg, seed=3)
    total, plain = grads_port(cfg, p, batch)
    rtotal, remat = grads_port(dataclasses.replace(cfg, remat=True), p, batch)
    assert total.item() == rtotal.item()
    flat = []
    T.tree_map(lambda a: flat.append(a), plain)
    flat_r = []
    T.tree_map(lambda a: flat_r.append(a), remat)
    assert len(flat) == len(flat_r) > 0
    assert all(torch.equal(a, b) for a, b in zip(flat, flat_r))
    jgrads = jax.grad(lambda q: JT.loss_fn(jcfg, q, jbatch)[0])(jp)
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        node = remat
        for key in path:
            node = node[key.key]
        want = np.asarray(g, np.float32)
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(node.numpy() / scale, want / scale,
                                   **LOGIT_TOL, err_msg=str(path))


def test_remat_is_off_in_decode_and_runs_every_layer_under_checkpoint(
        monkeypatch):
    """Every decoder layer of a prefill and every encoder layer goes
    through ``torch.utils.checkpoint`` with ``remat``; decode does not."""
    cfg, _, p, _ = family_pair("whisper", remat=True)
    calls = []
    real = T.checkpoint

    def spy(fn, *a, **k):
        calls.append(k.get("use_reentrant"))
        return real(fn, *a, **k)
    monkeypatch.setattr(T, "checkpoint", spy)
    batch, _, _ = make_inputs(cfg)
    _, cache, memory = T.prefill(cfg, p, batch["tokens"], extras_of(batch))
    assert calls == [False] * (cfg.encoder_layers + cfg.num_layers)
    cache = T.grow_cache(cfg, cache, 1)
    T.decode_step(cfg, p, batch["tokens"][:, :1], cache, S, memory)
    assert len(calls) == cfg.encoder_layers + cfg.num_layers


@pytest.mark.parametrize("family", ["qwen_moe", "internvl2", "whisper"])
def test_kernel_routing_counts_each_op(family):
    """With ``use_kernels``: MoE layers route their norms and prefill
    attention but no SwiGLU (the reference's ``moe_ffn`` takes no
    ``swiglu_fn``); InternVL2 routes like the dense stack; Whisper's
    LayerNorm and GELU route nothing but the decoder's prefill attention
    (its encoder and cross-attention are plain)."""
    cfg, _, p, _ = family_pair(family)
    names = ("rmsnorm", "swiglu", "flash_attention_bshd")
    calls = dict.fromkeys(names, 0)

    class Spy:
        def __getattr__(self, name):
            fn = getattr(ops.PLAIN, name)

            def wrapped(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return wrapped

    kcfg = dataclasses.replace(cfg, use_kernels=True)
    batch, _, n_prefix = make_inputs(cfg, patches=FAMILIES[family][1])
    _, cache, memory = T.prefill(kcfg, p, batch["tokens"], extras_of(batch),
                                 kernels=Spy())
    cache = T.grow_cache(kcfg, cache, 1)
    T.decode_step(kcfg, p, batch["tokens"][:, :1], cache, S + n_prefix,
                  memory, kernels=Spy())
    n = cfg.num_layers
    want = {"qwen_moe": {"rmsnorm": 2 * (2 * n + 1), "swiglu": 0,
                         "flash_attention_bshd": n},
            "internvl2": {"rmsnorm": 2 * (2 * n + 1), "swiglu": 2 * n,
                          "flash_attention_bshd": n},
            "whisper": {"rmsnorm": 0, "swiglu": 0,
                        "flash_attention_bshd": n}}[family]
    assert calls == want


@pytest.mark.parametrize("arch", ["internvl2-26b", "qwen2-moe-a2.7b",
                                  "whisper-large-v3", "xlstm-125m"])
def test_stack_params_equals_drawing_every_layer_then_stacking(arch):
    """``stack_params`` copies each layer into the preallocated stack as
    it draws it: bit-equal to drawing all layers and stacking them (the
    port's earlier form) from the same seed, a list for a mixed stack."""
    cfg = get_config(arch).reduced(num_layers=4 if arch == "xlstm-125m"
                                   else 3)
    got = T.stack_params(cfg, torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    layers = [T.layer_params(cfg, t, gen) for t in cfg.layer_types]
    want = layers if isinstance(got, list) else T._stack(layers)
    a, b = [], []
    T.tree_map(a.append, got)
    T.tree_map(b.append, want)
    assert len(a) == len(b) > 0
    assert all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(a, b))
    assert common.count_params(got) == common.count_params(want)


@pytest.mark.parametrize("family", list(FAMILIES)[:2] + ["internvl2",
                                                          "whisper"])
def test_params_from_jax_carries_every_part(family):
    """bf16 leaves of the MoE, the projector, the encoder and the
    cross-attention copied exactly into the reference's nesting; the
    port's own init draws a tree of the same names, shapes and dtypes."""
    cfg, jcfg, p, jp = family_pair(family, dtype="bfloat16")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = p
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == getattr(torch, leaf.dtype.name)
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    mine = T.init_params(cfg, torch.Generator().manual_seed(0))
    shape = lambda a: (tuple(a.shape), a.dtype)
    assert T.tree_map(shape, mine) == T.tree_map(shape, p)
    assert common.count_params(mine) == jcommon.count_params(jp)
