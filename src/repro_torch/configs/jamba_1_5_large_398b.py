"""Jamba-1.5-Large-398B: Mamba+attention 7:1 interleave, MoE every 2nd
layer, 16 experts top-2 [arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig, register


@register
def jamba_1_5_large_398b() -> ModelConfig:
    # period-8 pattern: attention at position 3 (as in Jamba), MoE on odd
    # positions (every 2nd layer).
    blocks = tuple("attn" if i == 3 else "mamba" for i in range(8))
    ffns = tuple("moe" if i % 2 == 1 else "mlp" for i in range(8))
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        source="arXiv:2403.19887",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab=65536, rope_type="none",
        n_experts=16, n_shared_experts=0, moe_top_k=2, d_expert=24576,
        block_pattern=blocks, ffn_pattern=ffns,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    )
