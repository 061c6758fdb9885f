"""Hymba-1.5B [arXiv:2411.13676] — hybrid: parallel attention + mamba
(SSD) heads in every block, sliding-window attention (meta tokens and
cross-layer KV sharing simplified away).

Sub-quadratic natively: SSM state + windowed attention -> long_500k runs.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        d_ff=5504, vocab_size=32001, head_dim=64,
        ssm_state=16, sliding_window=1024,
        source="arXiv:2411.13676",
    )
