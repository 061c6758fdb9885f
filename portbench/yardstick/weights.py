"""Weights drawn on the device from the run's seed, in the layout the
port's ``models.transformer`` takes (stacked (L, ...) layers) and in the
type they are served in: one ``torch.randn`` a leaf over all layers,
from one ``torch.Generator`` on the device, scaled as the port scales
its own draws (fan-in ** -0.5, the embedding 0.02). The reference reads
the same tensors, cast to f32."""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _leaf_specs(cfg: dict):
    """[(path, shape, scale)] of the random leaves; the constant leaves
    come from :func:`_constants`."""
    L, d, V = cfg["num_layers"], cfg["d_model"], cfg["vocab_size"]
    H, G = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    F = cfg["d_ff"]
    specs = [("embed", (V, d), 0.02),
             ("layers/attn/wq", (L, d, H, hd), d ** -0.5),
             ("layers/attn/wk", (L, d, G, hd), d ** -0.5),
             ("layers/attn/wv", (L, d, G, hd), d ** -0.5),
             ("layers/attn/wo", (L, H, hd, d), (H * hd) ** -0.5),
             ("layers/mlp/w_gate", (L, d, F), d ** -0.5),
             ("layers/mlp/w_up", (L, d, F), d ** -0.5),
             ("layers/mlp/w_down", (L, F, d), F ** -0.5)]
    if not cfg.get("tie_embeddings"):
        specs.append(("lm_head", (d, V), d ** -0.5))
    return specs


def _constants(cfg: dict, dt, dev):
    L, d = cfg["num_layers"], cfg["d_model"]
    ones = lambda *s: torch.ones(s, dtype=dt, device=dev)
    return {"layers/norm1/scale": ones(L, d),
            "layers/norm2/scale": ones(L, d), "final_norm/scale": ones(d)}


def _put(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def model_params(cfg: dict, seed: int, device) -> dict:
    """The backbone's parameter tree, drawn from ``seed`` on ``device``."""
    dt = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device).manual_seed(seed)
    tree: dict = {}
    for path, shape, scale in _leaf_specs(cfg):
        w = torch.randn(shape, generator=gen, dtype=dt, device=device)
        _put(tree, path, w.mul_(scale))
    for path, value in _constants(cfg, dt, device).items():
        _put(tree, path, value)
    return tree


def lora_adapters(cfg: dict, targets, rank: int, seed: int, device) -> dict:
    """Flat f32 adapters ``{target/a, target/b}``: a ~ N(0, 0.02) from
    its own stream of ``seed``, b = 0 (the merged model starts at the
    backbone)."""
    from .flops import lora_target_dims
    gen = torch.Generator(device).manual_seed(seed ^ 0x5EED)
    out = {}
    for t in targets:
        din, dout = lora_target_dims(cfg, t)
        L = cfg["num_layers"]
        out[t + "/a"] = torch.randn((L, din, rank), generator=gen,
                                    device=device).mul_(0.02)
        out[t + "/b"] = torch.zeros((L, rank, dout), device=device)
    return out

