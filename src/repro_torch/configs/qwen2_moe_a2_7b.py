"""Qwen1.5-MoE-A2.7B: 60 routed top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen2_moe_a2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=151936, rope_theta=1e6, qkv_bias=True,
        n_experts=60, n_shared_experts=4, moe_top_k=4, d_expert=1408,
        ffn_pattern=("moe",),
    )
