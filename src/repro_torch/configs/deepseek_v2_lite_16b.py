"""DeepSeek-V2-Lite-16B: MLA kv_lora=512, 2 shared + 64 routed top-6,
first layer dense [arXiv:2405.04434]."""
from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_v2_lite_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        source="arXiv:2405.04434",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=10944, vocab=102400, rope_theta=1e4,
        kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64, v_head_dim=128,
        n_experts=64, n_shared_experts=2, moe_top_k=6, d_expert=1408,
        n_prefix_layers=1, ffn_pattern=("moe",),
    )
