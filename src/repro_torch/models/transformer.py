"""The generic decoder / encoder-decoder stack of every architecture in
``repro_torch.configs`` (dense GQA, MoE, hybrid attention + mamba,
xLSTM, the vision prefix and Whisper's encoder-decoder), with its serve
path: the JAX package's ``models/transformer.py`` in PyTorch.

Parameters are nested dicts of tensors in the reference's layout. A
homogeneous stack (one type, and that type scannable) keeps its layers
stacked on a leading (L, ...) axis, and the reference's ``lax.scan``
over layers is a loop over that axis here; a heterogeneous stack
(xLSTM's mix of sLSTM and mLSTM) keeps a list of per-layer dicts, as
the reference does. Caches follow their params' form.

Public API:
  init_params(cfg, gen)                          -> params
  loss_fn(cfg, params, batch)                    -> (loss, metrics)
  forward(cfg, params, tokens, extras)           -> (logits, aux)
  prefill(cfg, params, tokens, extras)           -> (logits, cache, memory)
  init_decode_cache(cfg, B, cache_len)           -> cache (zeros)
  grow_cache(cfg, cache, extra)                  -> cache
  decode_step(cfg, params, tokens, cache, index, memory) -> (logits, cache)
  params_from_jax(tree)                          -> params

``extras`` carries the stub frontends' inputs: ``patch_embeds`` (B, P,
frontend_dim) for a vision config, projected and put before the tokens
(the logits of those P positions are dropped, and decode positions count
them), and ``frames`` (B, F, frontend_dim) for the encoder-decoder, whose
encoder output is the ``memory`` every decode step takes. The frontends
and the encoder compute in the promoted type of their f32 inputs and the
weights, as the reference does (:func:`layers.promoted`).

**Kernels.** With ``cfg.use_kernels`` set, and no ``flash_fn`` or
``swiglu_fn`` of the caller's own, prefill attention is
``kernels.flash_attention_bshd``, every SwiGLU MLP ``kernels.swiglu``,
every RMSNorm of the decoder stack (``norm1``, ``norm_x``, ``norm2``,
``final_norm``) ``kernels.rmsnorm`` and every prefill scan of the mLSTM
blocks and the mamba heads ``kernels.mlstm_scan_bshd``, for ``kernels``
the namespace passed (default :mod:`repro_torch.kernels.ops`;
``ops.PLAIN`` runs the plain versions). The blocks' own norms, the
sLSTM's feed-forward, the MoE layer (routing, experts and shared
experts), cross-attention and the whole encoder are plain, and decode
attends to the KV cache and steps the recurrent state in plain torch,
as the reference does. Without ``use_kernels`` the stack is the
reference's plain model. ``decode_step`` updates a stacked cache's
tensors in place; a list cache comes back as a new list.

**Remat.** With ``cfg.remat``, every layer of a pass that is not decode
(and every encoder layer) runs under ``torch.utils.checkpoint``
(non-reentrant): its activations are recomputed in the backward pass,
as ``jax.checkpoint`` does in the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..optim import tree_map
from . import moe, ssm
from .common import ModelConfig
from .layers import (apply_norm, attn_params, cross_attention, dense_init,
                     matmul, mlp, mlp_params, norm_params, self_attention,
                     sinusoidal_embedding)

SCANNABLE = {"attn", "moe", "hymba", "xattn", "mlstm"}
# Each layer type's top-level parameter names.
LAYER_KEYS = {
    "attn": {"norm1", "attn", "norm2", "mlp"},
    "moe": {"norm1", "attn", "norm2", "moe"},
    "xattn": {"norm1", "attn", "norm2", "norm_x", "xattn", "mlp"},
    "hymba": {"norm1", "attn", "norm2", "mamba", "mlp"},
    "mlstm": {"norm", "w_up", "w_gate", "conv_w", "wq", "wk", "wv", "w_if",
              "b_if", "head_norm", "w_down"},
    "slstm": {"norm", "w_gates", "b_gates", "r_gates", "head_norm",
              "ffn_norm", "w_ff_gate", "w_ff_up", "w_ff_down"},
}
# The top-level parameter names of a model
MODEL_KEYS = {"embed", "layers", "final_norm", "lm_head", "projector",
              "encoder"}


def _routes(cfg: ModelConfig, flash_fn, swiglu_fn, kernels):
    """(flash_fn, swiglu_fn, scan_fn, norm namespace) for a pass."""
    if not cfg.use_kernels:
        return flash_fn, swiglu_fn, None, None
    if kernels is None:
        from ..kernels import ops as kernels
    return (flash_fn or kernels.flash_attention_bshd,
            swiglu_fn or kernels.swiglu, kernels.mlstm_scan_bshd, kernels)


# ---------------------------------------------------------------------------
# Per-layer params and apply
# ---------------------------------------------------------------------------

def layer_params(cfg: ModelConfig, ltype: str, gen: torch.Generator):
    if ltype == "mlstm":
        return ssm.mlstm_block_params(cfg, gen)
    if ltype == "slstm":
        return ssm.slstm_block_params(cfg, gen)
    if ltype not in LAYER_KEYS:
        raise ValueError(f"unknown layer type {ltype}")
    p = {"norm1": norm_params(cfg, gen.device),
         "attn": attn_params(cfg, gen),
         "norm2": norm_params(cfg, gen.device)}
    if ltype == "moe":
        p["moe"] = moe.moe_params(cfg, gen)
        return p
    if ltype == "hymba":
        p["mamba"] = ssm.mamba_head_params(cfg, gen)
    elif ltype == "xattn":
        p["norm_x"] = norm_params(cfg, gen.device)
        p["xattn"] = attn_params(cfg, gen)
    p["mlp"] = mlp_params(cfg, gen)
    return p


def layer_apply(cfg: ModelConfig, ltype: str, p, x, positions, cache=None,
                memory=None, *, decode=False, build_cache=False,
                flash_fn=None, swiglu_fn=None, scan_fn=None, kernels=None):
    """One layer: (x, new_cache, aux). ``kernels`` is the RMSNorm namespace
    (None: the model's own norm); ``scan_fn`` the prefill scan of the
    mLSTM blocks and mamba heads (None: the plain oracle)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    keep = cache is not None or build_cache
    if ltype == "mlstm":
        state = conv = None
        if cache is not None:
            state, conv = cache["state"], cache["conv"]
        x, (state, conv) = ssm.mlstm_block_apply(
            cfg, p, x, state, conv, decode=decode, build_cache=build_cache,
            scan_fn=scan_fn)
        return x, ({"state": state, "conv": conv} if keep else None), aux
    if ltype == "slstm":
        state = cache["state"] if cache is not None else None
        x, state = ssm.slstm_block_apply(cfg, p, x, state)
        return x, ({"state": state} if keep else None), aux
    if ltype not in LAYER_KEYS:
        raise ValueError(f"unknown layer type {ltype}")
    kv = cache["kv"] if cache is not None else None
    h = apply_norm(cfg, p["norm1"], x, kernels)
    o, new_kv = self_attention(cfg, p["attn"], h, positions, causal=True,
                               kv_cache=kv, build_cache=build_cache,
                               flash_fn=flash_fn)
    if ltype == "hymba":
        state = conv = None
        if cache is not None:
            state, conv = cache["state"], cache["conv"]
        mamba_o, (state, conv) = ssm.mamba_head_apply(
            cfg, p["mamba"], h, state, conv, decode=decode,
            build_cache=build_cache, scan_fn=scan_fn)
        x = x + 0.5 * (o + mamba_o)           # parallel-head fusion
        newc = {"kv": new_kv, "state": state, "conv": conv}
    else:   # attn / moe / xattn
        x = x + o
        newc = {"kv": new_kv}
    if ltype == "xattn":
        h = apply_norm(cfg, p["norm_x"], x, kernels)
        x = x + cross_attention(cfg, p["xattn"], h, memory)
    h = apply_norm(cfg, p["norm2"], x, kernels)
    if ltype == "moe":
        y, aux = moe.moe_ffn(cfg, p["moe"], h)
        x = x + y
    else:
        x = x + mlp(cfg, p["mlp"], h, swiglu_fn)
    return x, (newc if keep else None), aux


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def _is_homogeneous(types) -> bool:
    """Whether a stack of these layer types keeps stacked (L, ...) params
    and caches (the reference's scanned stacks) rather than per-layer
    lists."""
    types = set(types)
    return len(types) == 1 and next(iter(types)) in SCANNABLE


def stack_params(cfg: ModelConfig, gen: torch.Generator, num_layers=None,
                 ltype=None):
    """Stacked (L, ...) params of a homogeneous stack, a list of per-layer
    params otherwise. A stacked tree is allocated once at its full depth
    and each layer, drawn in turn, is copied into it and freed: the peak
    is the stack and one layer, not the stack twice."""
    L = num_layers or cfg.num_layers
    types = [ltype] * L if ltype else list(cfg.layer_types)
    if not _is_homogeneous(types):
        return [layer_params(cfg, t, gen) for t in types]
    layer = layer_params(cfg, types[0], gen)
    out = tree_map(lambda a: a.new_empty((L,) + tuple(a.shape)), layer)
    for i in range(L):
        if i:
            layer = layer_params(cfg, types[i], gen)
        _store(out, i, layer)
        del layer
    return out


def _store(stacked, i: int, layer) -> None:
    if isinstance(stacked, dict):
        for k in stacked:
            _store(stacked[k], i, layer[k])
    else:
        stacked[i].copy_(layer)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _index(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _write_back(views, new):
    """Copy a layer's new cache into the stacked cache's views of it; the
    leaves that decode updated in place (the KV cache) are the views."""
    if isinstance(views, dict):
        for k in views:
            _write_back(views[k], new[k])
    elif new is not views:
        views.copy_(new)


def stack_apply(cfg, params, x, positions, cache=None, memory=None, *,
                decode=False, build_cache=False, flash_fn=None,
                swiglu_fn=None, kernels=None):
    """Apply the layer stack. Returns (x, new_cache, aux). ``kernels``:
    see the module docstring."""
    flash_fn, swiglu_fn, scan_fn, norm_ns = _routes(cfg, flash_fn, swiglu_fn,
                                                    kernels)
    types = list(cfg.layer_types)
    stacked = not isinstance(params, list)
    apply = layer_apply
    if cfg.remat and not decode:
        apply = functools.partial(checkpoint, layer_apply,
                                  use_reentrant=False)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    built = []
    for i, t in enumerate(types):
        p = _index(params, i) if stacked else params[i]
        c = None
        if cache is not None:
            c = _index(cache, i) if stacked else cache[i]
        x, nc, a = apply(cfg, t, p, x, positions, c, memory,
                         decode=decode, build_cache=build_cache,
                         flash_fn=flash_fn, swiglu_fn=swiglu_fn,
                         scan_fn=scan_fn, kernels=norm_ns)
        aux = aux + a
        if stacked and cache is not None:
            _write_back(c, nc)      # decode: the stacked cache, in place
        else:
            built.append(nc)
    if cache is not None:
        return x, (cache if stacked else built), aux
    if not build_cache:
        return x, None, aux
    return x, (_stack(built) if stacked else built), aux


# ---------------------------------------------------------------------------
# Cache construction (zeros)
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, ltype: str, B: int, cache_len: int,
                     dtype, device=None):
    G, hd, H = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)

    def kv_cache(length):
        W = min(length, cfg.sliding_window) if cfg.sliding_window else length
        return {"k": torch.zeros(B, W, G, hd, dtype=dtype, device=device),
                "v": torch.zeros(B, W, G, hd, dtype=dtype, device=device),
                "pos": torch.full((W,), -1, dtype=torch.int32,
                                  device=device)}

    def gla_state(dk, dv):
        return {"S": torch.zeros(B, H, dk, dv, **f32),
                "n": torch.zeros(B, H, dk, **f32),
                "m": torch.zeros(B, H, **f32)}

    def conv(width):
        return torch.zeros(B, cfg.conv_kernel - 1, width, dtype=dtype,
                           device=device)

    if ltype in ("attn", "moe", "xattn"):
        return {"kv": kv_cache(cache_len)}
    if ltype == "hymba":
        return {"kv": kv_cache(cache_len),
                "state": gla_state(cfg.ssm_state, d // H), "conv": conv(d)}
    if ltype == "mlstm":
        inner = cfg.ssm_expand * d
        return {"state": gla_state(inner // H, inner // H),
                "conv": conv(inner)}
    if ltype == "slstm":
        z = lambda: torch.zeros(B, H, d // H, **f32)
        return {"state": {"c": z(), "n": z(), "h": z(), "m": z()}}
    raise ValueError(ltype)


def init_decode_cache(cfg: ModelConfig, B: int, cache_len: int, dtype=None,
                      device=None):
    dtype = dtype or cfg.param_dtype
    per = [init_layer_cache(cfg, t, B, cache_len, dtype, device)
           for t in cfg.layer_types]
    return _stack(per) if _is_homogeneous(cfg.layer_types) else per


# ---------------------------------------------------------------------------
# Model init / top-level forward
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random weights at the reference's scales, drawn from ``gen`` on its
    device (``torch.Generator(device).manual_seed(seed)``)."""
    dt = cfg.param_dtype
    p = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                             scale=0.02),
         "layers": stack_params(cfg, gen),
         "final_norm": norm_params(cfg, gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    if cfg.frontend:      # the stub frontend's projector
        p["projector"] = {
            "w1": dense_init(gen, (cfg.frontend_dim, cfg.d_model), dt),
            "w2": dense_init(gen, (cfg.d_model, cfg.d_model), dt)}
    if cfg.is_enc_dec:
        p["encoder"] = {
            "layers": stack_params(cfg, gen, cfg.encoder_layers, "attn"),
            "final_norm": norm_params(cfg, gen.device)}
    return p


def _to_torch(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _layer_type(keys) -> str:
    for t, need in LAYER_KEYS.items():
        if set(keys) == need:
            return t
    raise ValueError(f"layer params {sorted(keys)} are none of the layer "
                     f"types {', '.join(LAYER_KEYS)}")


def _check_layers(layers) -> None:
    for layer in (layers if isinstance(layers, list) else [layers]):
        _layer_type(layer)


def params_from_jax(tree) -> dict:
    """The reference's ``init_params`` tree (numpy arrays; bf16 as
    ``ml_dtypes.bfloat16``) -> this module's tree on the CPU: the same
    nesting, the same dtypes, stacked (L, ...) layers as stacked, a list
    of per-layer dicts as a list. Layouts agree, so this copies."""
    extra = set(tree) - MODEL_KEYS
    if extra:
        raise ValueError(f"parameters {sorted(extra)} belong to no part of "
                         f"the model ({', '.join(sorted(MODEL_KEYS))})")
    _check_layers(tree["layers"])
    if "encoder" in tree:
        enc = tree["encoder"]
        if set(enc) != {"layers", "final_norm"}:
            raise ValueError(f"encoder params {sorted(enc)}: expected "
                             f"layers and final_norm")
        _check_layers(enc["layers"])
    out = tree_map(_to_torch, tree)
    stacks = [out["layers"]] + ([out["encoder"]["layers"]]
                                if "encoder" in out else [])
    for layers in stacks:
        if isinstance(layers, dict):
            depth = {a.shape[0] for a in _leaves(layers)}
            if len(depth) != 1:
                raise ValueError(f"stacked layer leaves disagree on L: "
                                 f"{depth}")
    return out


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def _project_frontend(params, embeds):
    pr = params["projector"]
    h = F.gelu(matmul(embeds, pr["w1"]), approximate="tanh")
    return matmul(h, pr["w2"])


def _encode(cfg, params, frames):
    """Whisper-style encoder over stub frame embeddings (B, F, fd): the
    projector, sinusoidal positions and non-causal, unwindowed ``"attn"``
    layers with their own final norm, all plain (the reference gives the
    encoder no kernels)."""
    x = _project_frontend(params, frames)
    B, S = x.shape[:2]
    x = x + sinusoidal_embedding(S, cfg.d_model, x.dtype, x.device)[None]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)

    def one_layer(p, x):
        h = apply_norm(cfg, p["norm1"], x)
        o, _ = self_attention(cfg, p["attn"], h, positions, causal=False,
                              window=0)
        x = x + o
        h = apply_norm(cfg, p["norm2"], x)
        return x + mlp(cfg, p["mlp"], h)

    if cfg.remat:
        one_layer = functools.partial(checkpoint, one_layer,
                                      use_reentrant=False)
    layers = params["encoder"]["layers"]
    stacked = not isinstance(layers, list)
    for i in range(cfg.encoder_layers if stacked else len(layers)):
        x = one_layer(_index(layers, i) if stacked else layers[i], x)
    return apply_norm(cfg, params["encoder"]["final_norm"], x)


def embed_inputs(cfg, params, tokens, extras=None):
    """Token embedding and the modality prefix or encoder. Returns (x,
    positions, n_prefix, memory)."""
    extras = extras or {}
    x = params["embed"][tokens]
    memory = None
    n_prefix = 0
    if cfg.frontend == "vision" and "patch_embeds" in extras:
        prefix = _project_frontend(params, extras["patch_embeds"]).to(x.dtype)
        x = torch.cat([prefix, x], dim=1)
        n_prefix = prefix.shape[1]
    if cfg.is_enc_dec:
        memory = _encode(cfg, params, extras["frames"])
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    if cfg.positional == "sinusoidal":
        x = x + sinusoidal_embedding(S, cfg.d_model, x.dtype, x.device)[None]
    return x, positions, n_prefix, memory


def unembed(cfg, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def forward(cfg: ModelConfig, params, tokens, extras=None, flash_fn=None,
            swiglu_fn=None, kernels=None):
    """Full-sequence logits (train path), without the modality prefix's
    positions. Returns (logits, aux)."""
    x, positions, n_prefix, memory = embed_inputs(cfg, params, tokens,
                                                  extras)
    x, _, aux = stack_apply(cfg, params["layers"], x, positions,
                            memory=memory, flash_fn=flash_fn,
                            swiglu_fn=swiglu_fn, kernels=kernels)
    x = apply_norm(cfg, params["final_norm"], x,
                   _routes(cfg, flash_fn, swiglu_fn, kernels)[3])
    if n_prefix:
        x = x[:, n_prefix:]
    return unembed(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch, flash_fn=None, swiglu_fn=None,
            kernels=None):
    """Weighted next-token cross-entropy.

    batch: tokens (B,S) int, targets (B,S) int (-1 = masked), weights
    (B,) federated per-client weights p_k (optional), plus the modality
    extras (``patch_embeds``, ``frames``).
    """
    extras = {k: batch[k] for k in ("patch_embeds", "frames") if k in batch}
    logits, aux = forward(cfg, params, batch["tokens"], extras,
                          flash_fn=flash_fn, swiglu_fn=swiglu_fn,
                          kernels=kernels)
    targets = batch["targets"]
    mask = (targets >= 0).to(torch.float32)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    tgt = targets.clamp_min(0).long()
    # -logp at the target through nll_loss, which DTensor keeps sharded:
    # gather's backward allocates its zeros at logp's global shape on
    # every device of a sharded run (the dry-run)
    nll = F.nll_loss(logp.flatten(0, 1), tgt.flatten(),
                     reduction="none").view(tgt.shape) * mask
    per_ex = nll.sum(-1) / mask.sum(-1).clamp_min(1.0)         # (B,)
    w = batch.get("weights")
    if w is None:
        loss = per_ex.mean()
    else:
        loss = (per_ex * w).sum() / w.sum().clamp_min(1e-9)
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": mask.sum()}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params, tokens, extras=None, flash_fn=None,
            swiglu_fn=None, kernels=None):
    """Run the prompt, build the cache. Returns (last logits, cache, memory)."""
    x, positions, _, memory = embed_inputs(cfg, params, tokens, extras)
    x, cache, _ = stack_apply(cfg, params["layers"], x, positions,
                              memory=memory, build_cache=True,
                              flash_fn=flash_fn, swiglu_fn=swiglu_fn,
                              kernels=kernels)
    x = apply_norm(cfg, params["final_norm"], x[:, -1:],
                   _routes(cfg, flash_fn, swiglu_fn, kernels)[3])
    return unembed(cfg, params, x), cache, memory


def grow_cache(cfg: ModelConfig, cache, extra: int):
    """Extend a full (non-ring) KV cache by ``extra`` decode slots, per
    layer for a list cache; a windowed (ring) cache and a cache with no
    KV (the recurrent layers) are left as they are."""
    if cfg.sliding_window:
        return cache
    if isinstance(cache, list):
        return [_grow_kv(c, extra, 1) for c in cache]
    return _grow_kv(cache, extra, 2)


def _grow_kv(cache, extra: int, axis: int):
    """Pad a cache's k, v (sequence at ``axis``) and pos (its last axis)."""
    if "kv" not in cache:
        return cache
    kv = cache["kv"]
    pad = lambda a: F.pad(a, (0, 0) * (a.ndim - 1 - axis) + (0, extra))
    return {**cache, "kv": {"k": pad(kv["k"]), "v": pad(kv["v"]),
                            "pos": F.pad(kv["pos"], (0, extra), value=-1)}}


def decode_step(cfg: ModelConfig, params, tokens, cache, index, memory=None,
                flash_fn=None, swiglu_fn=None, kernels=None):
    """One decode step. tokens: (B, 1); index: the absolute position (an
    int; it counts a vision prefix); memory: the encoder output prefill
    returned (encoder-decoder only). Returns (logits, cache); a stacked cache's tensors are updated
    in place, a list cache comes back as a new list."""
    x = params["embed"][tokens]
    if cfg.positional == "sinusoidal":
        x = x + _sin_at(int(index), cfg.d_model, x.dtype, x.device)[None, None]
    positions = torch.full((x.shape[0], 1), int(index), dtype=torch.int32,
                           device=x.device)
    x, cache, _ = stack_apply(cfg, params["layers"], x, positions,
                              cache=cache, memory=memory, decode=True,
                              flash_fn=flash_fn, swiglu_fn=swiglu_fn,
                              kernels=kernels)
    x = apply_norm(cfg, params["final_norm"], x,
                   _routes(cfg, flash_fn, swiglu_fn, kernels)[3])
    return unembed(cfg, params, x), cache


def _sin_at(index: int, d_model: int, dtype, device):
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    angle = float(index) / torch.pow(10_000.0, dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)])[:d_model].to(dtype)
