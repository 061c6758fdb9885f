"""xLSTM-125M [arXiv:2405.04517] — sLSTM + mLSTM blocks, no separate FFN
(d_ff=0; blocks carry their own projections). Block pattern follows the
paper's mostly-mLSTM ratio with sLSTM at positions 3 and 7.

Sub-quadratic natively (recurrent state): long_500k runs."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    pattern = tuple("slstm" if i in (3, 7) else "mlstm" for i in range(12))
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        ssm_state=16, block_pattern=pattern, positional="none",
        source="arXiv:2405.04517",
    )
