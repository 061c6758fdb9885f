"""The decoder stack for the dense ``"attn"`` layer type, with its serve
path: the JAX package's ``models/transformer.py`` in PyTorch.

Parameters are nested dicts of tensors in the reference's layout, the
layers stacked on a leading (L, ...) axis; the reference's ``lax.scan``
over layers is a loop over that axis here.

Public API:
  init_params(cfg, gen)                          -> params
  loss_fn(cfg, params, batch)                    -> (loss, metrics)
  forward(cfg, params, tokens)                   -> (logits, aux)
  prefill(cfg, params, tokens)                   -> (logits, cache, memory)
  init_decode_cache(cfg, B, cache_len)           -> cache (zeros)
  grow_cache(cfg, cache, extra)                  -> cache
  decode_step(cfg, params, tokens, cache, index) -> (logits, cache)
  params_from_jax(tree)                          -> params

**Kernels.** With ``cfg.use_kernels`` set, and no ``flash_fn`` or
``swiglu_fn`` of the caller's own, prefill attention is
``kernels.flash_attention_bshd``, every SwiGLU ``kernels.swiglu`` and
every RMSNorm ``kernels.rmsnorm``, for ``kernels`` the namespace passed
(default :mod:`repro_torch.kernels.ops`; ``ops.PLAIN`` runs the plain
versions). Decode attends to the KV cache in plain torch, as the
reference does. Without ``use_kernels`` the stack is the reference's
plain model. ``decode_step`` updates the cache's tensors in place.

Not ported (each raises ``NotImplementedError``): the MoE, mLSTM /
sLSTM, Hymba and cross-attention layer types, the vision / audio
frontends and the encoder (ROADMAP.md Queue 1 item 9), and ``remat``
(this slice has no backward path).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import ModelConfig
from .layers import (apply_norm, attn_params, dense_init, mlp, mlp_params,
                     norm_params, self_attention, sinusoidal_embedding)

_CUT = ("is not ported yet (ROADMAP.md Queue 1 item 9: the rest of the "
        "models)")


def _check_supported(cfg: ModelConfig) -> None:
    types = set(cfg.layer_types)
    if types != {"attn"}:
        raise NotImplementedError(f"layer types {sorted(types)} {_CUT}; the "
                                  "port runs the dense 'attn' stack")
    if cfg.is_enc_dec:
        raise NotImplementedError(f"the encoder-decoder stack {_CUT}")
    if cfg.remat:
        raise NotImplementedError("remat: this slice has no backward path")


def _routes(cfg: ModelConfig, flash_fn, swiglu_fn, kernels):
    """(flash_fn, swiglu_fn, norm namespace) for a pass."""
    if not cfg.use_kernels:
        return flash_fn, swiglu_fn, None
    if kernels is None:
        from ..kernels import ops as kernels
    return (flash_fn or kernels.flash_attention_bshd,
            swiglu_fn or kernels.swiglu, kernels)


def tree_map(fn, tree):
    """``fn`` over every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Per-layer params and apply
# ---------------------------------------------------------------------------

def layer_params(cfg: ModelConfig, ltype: str, gen: torch.Generator):
    if ltype != "attn":
        raise NotImplementedError(f"layer type {ltype!r} {_CUT}")
    return {"norm1": norm_params(cfg, gen.device),
            "attn": attn_params(cfg, gen),
            "norm2": norm_params(cfg, gen.device),
            "mlp": mlp_params(cfg, gen)}


def layer_apply(cfg: ModelConfig, ltype: str, p, x, positions, cache=None,
                memory=None, *, decode=False, build_cache=False,
                flash_fn=None, swiglu_fn=None, kernels=None):
    """One layer: (x, new_cache, aux). ``kernels`` is the RMSNorm namespace
    (None: the model's own norm)."""
    if ltype != "attn":
        raise NotImplementedError(f"layer type {ltype!r} {_CUT}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = cache["kv"] if cache is not None else None
    h = apply_norm(cfg, p["norm1"], x, kernels)
    o, new_kv = self_attention(cfg, p["attn"], h, positions, causal=True,
                               kv_cache=kv, build_cache=build_cache,
                               flash_fn=flash_fn)
    x = x + o
    h = apply_norm(cfg, p["norm2"], x, kernels)
    x = x + mlp(cfg, p["mlp"], h, swiglu_fn)
    newc = {"kv": new_kv} if (cache is not None or build_cache) else None
    return x, newc, aux


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def stack_params(cfg: ModelConfig, gen: torch.Generator, num_layers=None,
                 ltype=None):
    """Stacked (L, ...) params of a homogeneous stack."""
    L = num_layers or cfg.num_layers
    t = ltype or cfg.layer_types[0]
    layers = [layer_params(cfg, t, gen) for _ in range(L)]
    return _stack(layers)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _index(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def stack_apply(cfg, params, x, positions, cache=None, memory=None, *,
                decode=False, build_cache=False, flash_fn=None,
                swiglu_fn=None, kernels=None):
    """Apply the layer stack. Returns (x, new_cache, aux). ``kernels``:
    see the module docstring."""
    _check_supported(cfg)
    flash_fn, swiglu_fn, norm_ns = _routes(cfg, flash_fn, swiglu_fn, kernels)
    L = cfg.num_layers
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    built = []
    for i in range(L):
        c = _index(cache, i) if cache is not None else None
        x, nc, a = layer_apply(cfg, "attn", _index(params, i), x, positions,
                               c, memory, decode=decode,
                               build_cache=build_cache and cache is None,
                               flash_fn=flash_fn, swiglu_fn=swiglu_fn,
                               kernels=norm_ns)
        aux = aux + a
        if cache is None and build_cache:
            built.append(nc)
    if cache is not None:       # decode: the stacked views were updated
        return x, cache, aux
    return x, (_stack(built) if build_cache else None), aux


# ---------------------------------------------------------------------------
# Cache construction (zeros)
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, ltype: str, B: int, cache_len: int,
                     dtype, device=None):
    if ltype != "attn":
        raise NotImplementedError(f"layer type {ltype!r} {_CUT}")
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    return {"kv": {"k": torch.zeros(B, W, G, hd, dtype=dtype, device=device),
                   "v": torch.zeros(B, W, G, hd, dtype=dtype, device=device),
                   "pos": torch.full((W,), -1, dtype=torch.int32,
                                     device=device)}}


def init_decode_cache(cfg: ModelConfig, B: int, cache_len: int, dtype=None,
                      device=None):
    _check_supported(cfg)
    dtype = dtype or cfg.param_dtype
    return _stack([init_layer_cache(cfg, "attn", B, cache_len, dtype, device)
                   for _ in range(cfg.num_layers)])


# ---------------------------------------------------------------------------
# Model init / top-level forward
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random weights at the reference's scales, drawn from ``gen`` on its
    device (``torch.Generator(device).manual_seed(seed)``)."""
    _check_supported(cfg)
    if cfg.frontend:
        raise NotImplementedError(f"the {cfg.frontend} frontend {_CUT}")
    dt = cfg.param_dtype
    p = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                             scale=0.02),
         "layers": stack_params(cfg, gen),
         "final_norm": norm_params(cfg, gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return p


def _to_torch(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree) -> dict:
    """The reference's ``init_params`` tree of a dense ``"attn"`` stack
    (numpy arrays; bf16 as ``ml_dtypes.bfloat16``) -> this module's tree on
    the CPU: the same nesting, the stacked (L, ...) layout, the same
    dtypes. Layouts agree, so this copies."""
    extra = set(tree) - {"embed", "layers", "final_norm", "lm_head"}
    if extra:
        raise NotImplementedError(f"parameters {sorted(extra)} belong to "
                                  f"parts that {_CUT}")
    if not isinstance(tree["layers"], dict):
        raise ValueError("expected the stacked (scanned) layer params")
    need = {"norm1", "attn", "norm2", "mlp"}
    if set(tree["layers"]) != need:
        raise NotImplementedError(f"layer params {sorted(tree['layers'])}: "
                                  f"only the dense 'attn' layer ({sorted(need)}) "
                                  f"is ported")
    out = tree_map(_to_torch, tree)
    depth = {a.shape[0] for a in _leaves(out["layers"])}
    if len(depth) != 1:
        raise ValueError(f"stacked layer leaves disagree on L: {depth}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def embed_inputs(cfg, params, tokens, extras=None):
    """Token embedding. Returns (x, positions, n_prefix, memory)."""
    if extras and ({"patch_embeds", "frames"} & set(extras)):
        raise NotImplementedError(f"modality extras {sorted(extras)}: the "
                                  f"frontends {_CUT}")
    if cfg.is_enc_dec:
        raise NotImplementedError(f"the encoder {_CUT}")
    x = params["embed"][tokens]
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    if cfg.positional == "sinusoidal":
        x = x + sinusoidal_embedding(S, cfg.d_model, x.dtype, x.device)[None]
    return x, positions, 0, None


def unembed(cfg, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def forward(cfg: ModelConfig, params, tokens, extras=None, flash_fn=None,
            swiglu_fn=None, kernels=None):
    """Full-sequence logits (train path). Returns (logits, aux)."""
    x, positions, _, memory = embed_inputs(cfg, params, tokens, extras)
    x, _, aux = stack_apply(cfg, params["layers"], x, positions,
                            memory=memory, flash_fn=flash_fn,
                            swiglu_fn=swiglu_fn, kernels=kernels)
    x = apply_norm(cfg, params["final_norm"], x,
                   _routes(cfg, flash_fn, swiglu_fn, kernels)[2])
    return unembed(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch, flash_fn=None, swiglu_fn=None,
            kernels=None):
    """Weighted next-token cross-entropy.

    batch: tokens (B,S) int, targets (B,S) int (-1 = masked), weights
    (B,) federated per-client weights p_k (optional).
    """
    logits, aux = forward(cfg, params, batch["tokens"], flash_fn=flash_fn,
                          swiglu_fn=swiglu_fn, kernels=kernels)
    targets = batch["targets"]
    mask = (targets >= 0).to(torch.float32)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    tgt = targets.clamp_min(0).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0] * mask
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
                   _routes(cfg, flash_fn, swiglu_fn, kernels)[2])
    return unembed(cfg, params, x), cache, memory


def grow_cache(cfg: ModelConfig, cache, extra: int):
    """Extend a full (non-ring) stacked KV cache by ``extra`` decode slots."""
    if cfg.sliding_window or "kv" not in cache:
        return cache
    kv = cache["kv"]                              # k, v: (L, B, S, G, hd)
    pad = lambda a: F.pad(a, (0, 0, 0, 0, 0, extra))
    return {**cache, "kv": {"k": pad(kv["k"]), "v": pad(kv["v"]),
                            "pos": F.pad(kv["pos"], (0, extra), value=-1)}}


def decode_step(cfg: ModelConfig, params, tokens, cache, index, memory=None,
                flash_fn=None, swiglu_fn=None, kernels=None):
    """One decode step. tokens: (B, 1); index: the absolute position (an
    int). Returns (logits, cache); the cache's tensors are updated in
    place."""
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
                   _routes(cfg, flash_fn, swiglu_fn, kernels)[2])
    return unembed(cfg, params, x), cache


def _sin_at(index: int, d_model: int, dtype, device):
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    angle = float(index) / torch.pow(10_000.0, dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)])[:d_model].to(dtype)
