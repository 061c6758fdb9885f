"""Operations and bytes from shapes: the numerators of ``mfu`` and of
each kernel's roofline share.

The model counts are of the operations the algorithm needs: every
product of a weight once a token (2 operations a multiply-add), the
attention's two products over the causal pairs, and the LM head once as a product where it is
needed. Nothing is counted twice for recomputation, and elementwise
work is left out. ``model_flops_per_token`` is a frozen copy of the
port's ``models.common.model_flops_per_token`` (6 N), kept beside them
for comparison.
"""
from __future__ import annotations


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def layer_weights(cfg: dict) -> int:
    """Weights a token passes through in one layer (multiply-adds a
    token): q, k, v, o; the SwiGLU MLP."""
    d, hd = cfg["d_model"], head_dim(cfg)
    H, G = cfg["num_heads"], cfg["num_kv_heads"]
    if cfg["family"] != "dense":
        raise ValueError(f"no count for family {cfg['family']!r}")
    return d * hd * (2 * H + 2 * G) + 3 * d * cfg["d_ff"]


def attention_pairs(S: int) -> int:
    """Query-key pairs of one causal sequence of S tokens."""
    return S * (S + 1) // 2


def forward_flops(cfg: dict, B: int, S: int, head_positions: int) -> float:
    """One forward pass over B sequences of S tokens, the LM head at
    ``head_positions`` positions a sequence."""
    L, d, hd, H = (cfg["num_layers"], cfg["d_model"], head_dim(cfg),
                   cfg["num_heads"])
    tokens = B * S
    f = 2.0 * layer_weights(cfg) * tokens * L
    f += 4.0 * hd * H * attention_pairs(S) * B * L
    f += 2.0 * d * cfg["vocab_size"] * B * head_positions
    return f


def train_flops(cfg: dict, B: int, S: int) -> float:
    """Forward and backward (activations and weights: twice the
    forward) over B x S tokens, the head at every position."""
    return 3.0 * forward_flops(cfg, B, S, S)


def lora_target_dims(cfg: dict, target: str) -> tuple[int, int]:
    """(din, dout) of a LoRA target leaf of one layer."""
    d, hd = cfg["d_model"], head_dim(cfg)
    dims = {"attn/wq": (d, cfg["num_heads"] * hd),
            "attn/wv": (d, cfg["num_kv_heads"] * hd),
            "mlp/w_up": (d, cfg["d_ff"])}
    return dims[target]


def lora_step_flops(cfg: dict, B: int, S: int, rank: int,
                    targets) -> float:
    """One local step of LoRA fine-tuning over B x S tokens: the
    forward, the backward to the activations through the frozen
    backbone (as many operations as the forward), and the adapters'
    own products, forward and backward (x a, (x a) b and their
    gradients: 6 r (din + dout) a token and target a layer). The
    backbone's weight gradients are not needed and not counted."""
    f = 2.0 * forward_flops(cfg, B, S, S)
    per_tok = sum(6.0 * rank * sum(lora_target_dims(cfg, t)) for t in targets)
    return f + per_tok * B * S * cfg["num_layers"]


def model_flops_per_token(cfg: dict) -> float:
    """Frozen copy of the port's 6 N count for a dense config (N without
    embeddings)."""
    d, hd = cfg["d_model"], head_dim(cfg)
    att = d * hd * (2 * cfg["num_heads"] + 2 * cfg["num_kv_heads"])
    ffn = 3 * d * cfg["d_ff"]
    return 6.0 * cfg["num_layers"] * (att + ffn)


# -- kernels: (operations, bytes) of one call --------------------------------

def swiglu_cost(M: int, D: int, F: int, itemsize: int = 2):
    """silu(x Wg) * (x Wu): two products; x, Wg, Wu read once, the
    (M, F) result written once."""
    return 4.0 * M * D * F, itemsize * (M * D + 2 * D * F + M * F)


def flash_attention_cost(B: int, H: int, G: int, S: int, hd: int,
                         itemsize: int = 2):
    """Causal GQA attention: QK^T and PV over the pairs; q, k, v read
    once and o written once."""
    flops = 4.0 * hd * H * attention_pairs(S) * B
    nbytes = itemsize * B * S * hd * (2 * H + 2 * G)
    return flops, nbytes


def fedavg_agg_quality_cost(K: int, P: int, itemsize: int = 4):
    """Aggregate and Gram terms of K updates of P: U read once, the
    aggregate written once; 4 K P operations (the weighted sum, the
    dots with the aggregate and the squares), at the f32 rate."""
    return 4.0 * K * P, itemsize * (K + 1) * P + 8 * K
