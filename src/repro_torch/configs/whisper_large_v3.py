"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder; mel+conv
frontend is a STUB (the carve-out): input_specs() feeds 1500 precomputed
frame embeddings to the encoder; the decoder cross-attends.

Decode shapes exercise the decoder with a KV cache; 500k decoder context
is out-of-domain for whisper but mechanically supported via the window
variant."""
from repro_torch.models.common import ModelConfig

NUM_FRAMES = 1500    # 30 s of audio after the conv frontend's 2x stride


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        d_ff=5120, vocab_size=51866, head_dim=64,
        encoder_layers=32, cross_attention=True,
        block_pattern=tuple(["xattn"] * 32),
        positional="sinusoidal", norm="layernorm", act="gelu",
        frontend="audio", frontend_seq=NUM_FRAMES, frontend_dim=128,
        source="arXiv:2212.04356",
    )
