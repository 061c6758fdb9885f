"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE 16
experts top-1 + 1 shared expert, early fusion (modality prefix tokens
via the stub vision frontend)."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=8192, vocab_size=202048, head_dim=128,
        num_experts=16, num_shared_experts=1, top_k=1, moe_d_ff=8192,
        rope_theta=500_000.0,
        frontend="vision", frontend_seq=0, frontend_dim=1408,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
