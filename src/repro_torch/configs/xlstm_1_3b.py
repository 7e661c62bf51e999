"""xLSTM-1.3B: sLSTM + mLSTM blocks, 7:1 interleave [arXiv:2405.04517].
d_ff=0 per assignment => blocks carry their own projections."""
from repro_torch.configs.base import ModelConfig, register


@register
def xlstm_1_3b() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm", source="arXiv:2405.04517",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
        d_ff=0, vocab=50304, rope_type="none",
        block_pattern=("mlstm",) * 7 + ("slstm",),
        ffn_pattern=("none",) * 8,
    )
