"""InternVL2-26B [arXiv:2404.16821] — InternLM2-20B-class language
backbone consuming InternViT patch embeddings. The ViT is a STUB (the
assignment's carve-out): input_specs() feeds precomputed patch
embeddings (256 per image tile) through a 2-layer MLP projector."""
from repro_torch.models.common import ModelConfig

PATCH_TOKENS = 256   # InternVL pixel-shuffled tokens per tile


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=92553, head_dim=128,
        rope_theta=1_000_000.0,
        frontend="vision", frontend_seq=PATCH_TOKENS, frontend_dim=1024,
        source="arXiv:2404.16821",
    )
