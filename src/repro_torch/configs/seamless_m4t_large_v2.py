"""SeamlessM4T-large-v2 transformer backbone: 24-layer speech encoder
(stub frontend supplies frame embeddings) + 24-layer text decoder with
cross-attention [arXiv:2308.11596]."""
from repro_torch.configs.base import ModelConfig, register


@register
def seamless_m4t_large_v2() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        source="arXiv:2308.11596",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=8192, vocab=256206, n_encoder_layers=24, frontend="audio",
        rope_type="none",
    )
