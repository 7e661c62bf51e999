"""Qwen2-VL-72B language backbone: M-RoPE, dynamic-resolution vision stub
[arXiv:2409.12191]."""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen2_vl_72b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="dense", source="arXiv:2409.12191",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab=152064, rope_theta=1e6, qkv_bias=True,
        rope_type="mrope", mrope_sections=(16, 24, 24), frontend="vision",
    )
