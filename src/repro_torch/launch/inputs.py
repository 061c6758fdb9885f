"""Input specifications for every (architecture x input shape) pair, and
the step each shape runs: the JAX package's ``launch/inputs.py`` in
PyTorch.

``input_specs`` returns meta tensors (shape and dtype, no storage) for
every model input: they stand where the reference's
``jax.ShapeDtypeStruct`` stands, as the dry-run's raw material.
``make_train_step`` / ``make_prefill_step`` / ``make_serve_step`` build
the step each shape runs: train_4k -> a FedSGD step, prefill_32k -> a
prefill, decode_32k / long_500k -> one decode step against a seq_len
cache.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.fl.round import make_fedsgd_step
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, model_flops_per_token
from repro_torch.optim import adam

SHAPES = {
    #               seq_len  global_batch  kind
    "train_4k":    (4_096,   256,          "train"),
    "prefill_32k": (32_768,  32,           "prefill"),
    "decode_32k":  (32_768,  128,          "decode"),
    "long_500k":   (524_288, 1,            "decode"),
}

LONG_WINDOW = 8_192   # generic sliding-window variant for long_500k


def shape_dims(shape) -> tuple:
    """``(seq_len, global_batch, kind)`` of a shape: a name in
    :data:`SHAPES`, or such a tuple itself (a shape of one's own)."""
    return SHAPES[shape] if isinstance(shape, str) else tuple(shape)


def shape_config(cfg: ModelConfig, shape, *,
                 remat: bool = True) -> ModelConfig:
    """Per-shape config adjustments (window for long-context, remat for
    training)."""
    kind = shape_dims(shape)[2]
    upd = {}
    if shape == "long_500k" and cfg.family not in ("ssm",):
        # sub-quadratic rule: windowed attention unless natively recurrent.
        if not cfg.sliding_window or cfg.sliding_window > LONG_WINDOW:
            upd["sliding_window"] = LONG_WINDOW
    if kind == "train" and remat:
        upd["remat"] = True
    return dataclasses.replace(cfg, **upd) if upd else cfg


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape) -> dict:
    """Train-batch specs. For VLM archs the vision prefix occupies part
    of the sequence budget so total length == seq_len."""
    S, B, kind = shape_dims(shape)
    assert kind == "train"
    S_text = S
    batch = {}
    if cfg.family == "vlm" and cfg.frontend_seq:
        S_text = S - cfg.frontend_seq
        batch["patch_embeds"] = _spec((B, cfg.frontend_seq, cfg.frontend_dim),
                                      torch.float32)
    if cfg.is_enc_dec:
        batch["frames"] = _spec((B, cfg.frontend_seq, cfg.frontend_dim),
                                torch.float32)
    batch["tokens"] = _spec((B, S_text), torch.int32)
    batch["targets"] = _spec((B, S_text), torch.int32)
    batch["weights"] = _spec((B,), torch.float32)   # federated p_k
    return batch


def prefill_specs(cfg: ModelConfig, shape) -> dict:
    S, B, _ = shape_dims(shape)
    batch = {"tokens": _spec((B, S if cfg.family != "vlm"
                              else S - cfg.frontend_seq), torch.int32)}
    if cfg.family == "vlm" and cfg.frontend_seq:
        batch["patch_embeds"] = _spec((B, cfg.frontend_seq, cfg.frontend_dim),
                                      torch.float32)
    if cfg.is_enc_dec:
        batch["frames"] = _spec((B, cfg.frontend_seq, cfg.frontend_dim),
                                torch.float32)
    return batch


def decode_specs(cfg: ModelConfig, shape) -> tuple:
    """Returns (batch_specs, cache_specs): one new token against a KV
    cache of seq_len (ring-buffer of `window` for windowed archs)."""
    S, B, _ = shape_dims(shape)
    batch = {"tokens": _spec((B, 1), torch.int32),
             "index": _spec((), torch.int32)}
    if cfg.is_enc_dec:
        batch["memory"] = _spec((B, cfg.frontend_seq, cfg.d_model),
                                cfg.param_dtype)
    cache = T.init_decode_cache(cfg, B, S, device="meta")
    return batch, cache


def input_specs(cfg: ModelConfig, shape):
    kind = shape_dims(shape)[2]
    if kind == "train":
        return {"batch": batch_specs(cfg, shape)}
    if kind == "prefill":
        return {"batch": prefill_specs(cfg, shape)}
    batch, cache = decode_specs(cfg, shape)
    return {"batch": batch, "cache": cache}


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, lr: float = 1e-4,
                    microbatches: int = 1):
    optimizer = adam(lr, grad_clip=1.0)
    loss = functools.partial(T.loss_fn, cfg)
    step = make_fedsgd_step(loss, optimizer, microbatches=microbatches,
                            unroll_microbatches=cfg.unroll_layers)
    return step, optimizer


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        extras = {k: batch[k] for k in ("patch_embeds", "frames")
                  if k in batch}
        logits, cache, memory = T.prefill(cfg, params, batch["tokens"],
                                          extras)
        return logits, cache
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, batch, cache) -> (logits, cache)``. The
    port's ``decode_step`` reads ``batch["index"]`` as a Python int (a
    0-d tensor is read with ``int``), and updates a stacked cache in
    place."""
    def serve_step(params, batch, cache):
        logits, new_cache = T.decode_step(
            cfg, params, batch["tokens"], cache, batch["index"],
            memory=batch.get("memory"))
        return logits, new_cache
    return serve_step


def model_flops_for(cfg: ModelConfig, shape) -> float:
    """MODEL_FLOPS = 6·N·D for training (fwd+bwd), 2·N·D inference."""
    S, B, kind = shape_dims(shape)
    per_tok = model_flops_per_token(cfg)       # already includes the 6x
    if kind == "train":
        return per_tok * B * S
    if kind == "prefill":
        return per_tok / 3.0 * B * S           # forward only: 2·N·D
    return per_tok / 3.0 * B * 1               # one token per sequence
