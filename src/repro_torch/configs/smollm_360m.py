"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M] — llama-arch small; also
the backbone for the small-scale federated LM experiments."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
        d_ff=2560, vocab_size=49152, head_dim=64,
        tie_embeddings=True,
        # the reference cites the 135M model card for this 360M shape;
        # copied as it stands (ROADMAP.md Queue 3)
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
