"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense GQA
kv=8, 128k context; the sliding-window variant (8192) powers long_500k."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=131072, head_dim=128,
        rope_theta=1_000_000.0,
        source="hf:mistralai/Mistral-Nemo-Base-2407",
    )
