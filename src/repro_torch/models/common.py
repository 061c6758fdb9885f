"""Model configuration shared by the transformer families.

A copy of the JAX package's ``models/common.py``: one frozen
``ModelConfig`` covers the six families (dense / moe / hybrid / ssm /
vlm / audio); family-specific fields are zero or None when unused. The
port's transformer runs every family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight
    pad_experts_to: int = 0          # pad expert count for even EP sharding

    # --- SSM / hybrid ---
    ssm_state: int = 0               # N (state dim per channel)
    ssm_expand: int = 2              # inner expansion for mamba/mLSTM blocks
    conv_kernel: int = 4             # depthwise causal conv width
    block_pattern: tuple = ()        # per-layer types for heterogeneous stacks
    chunk_size: int = 256            # chunkwise-parallel scan chunk

    # --- attention ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 -> full attention
    positional: str = "rope"         # rope | sinusoidal | none
    logit_soft_cap: float = 0.0

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    cross_attention: bool = False

    # --- stub modality frontend (vlm/audio carve-out) ---
    frontend: Optional[str] = None   # "vision" | "audio"
    frontend_seq: int = 0            # patches / frames fed to the backbone
    frontend_dim: int = 0            # embedding dim produced by the stub

    # --- misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Route the hot paths (RMSNorm, SwiGLU, prefill attention) through the
    # port's CUDA kernels; the reference's ``use_pallas`` under another name.
    use_kernels: bool = False
    remat: bool = False              # activation checkpointing over layers
    unroll_layers: bool = False      # unroll the stack (same loop here)
    source: str = ""                 # citation for the assigned config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def layer_types(self) -> tuple:
        """Per-layer block types; homogeneous stacks return one type."""
        if self.block_pattern:
            if len(self.block_pattern) != self.num_layers:
                raise ValueError("block_pattern length != num_layers")
            return tuple(self.block_pattern)
        default = {
            "dense": "attn", "moe": "moe", "vlm": "attn", "audio": "attn",
            "hybrid": "hymba", "ssm": "mlstm",
        }[self.family]
        return tuple([default] * self.num_layers)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                num_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """CPU-smoke-test variant of the same family (<= 2 layers,
        d_model <= 512, <= 4 experts), as the reference builds it."""
        hd = min(self.resolved_head_dim, 64)
        heads = max(2, min(self.num_heads, d_model // hd))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        pattern = self.block_pattern[:num_layers] if self.block_pattern else ()
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=heads * hd,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 2 * d_model) if self.d_ff else 0,
            vocab_size=vocab,
            num_experts=min(self.num_experts, num_experts) if self.is_moe else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            moe_d_ff=min(self.moe_d_ff, d_model) if self.is_moe else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            block_pattern=pattern,
            chunk_size=32,
            encoder_layers=min(self.encoder_layers, num_layers),
            frontend_seq=min(self.frontend_seq, 16) if self.frontend_seq else 0,
            frontend_dim=min(self.frontend_dim, 128) if self.frontend_dim else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
        )


def count_params(params) -> int:
    """Elements over every tensor of nested dicts and lists."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, list):
        return sum(count_params(v) for v in params)
    return params.numel()


def model_flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS ~ 6·N (dense) or 6·N_active per token. N excludes
    embeddings, includes active experts."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    att = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)  # qkvo
    if cfg.is_moe:
        act_experts = cfg.top_k + cfg.num_shared_experts
        ffn = act_experts * 3 * d * cfg.moe_d_ff + d * cfg.num_experts
    elif cfg.d_ff:
        ffn = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    else:  # ssm blocks carry their own projections
        inner = cfg.ssm_expand * d
        ffn = 2 * d * inner + 3 * inner * inner // max(cfg.num_heads, 1)
    n_active = cfg.num_layers * (att + ffn)
    if cfg.is_enc_dec:
        n_active += cfg.encoder_layers * (att + ffn + att)  # + cross-attn
    return 6.0 * n_active
