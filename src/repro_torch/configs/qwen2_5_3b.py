"""Qwen2.5-3B: dense GQA kv=2, QKV bias [hf:Qwen/Qwen2.5-0.5B]."""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen2_5_3b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense", source="hf:Qwen/Qwen2.5-0.5B",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
        d_ff=11008, vocab=151936, rope_theta=1e6, qkv_bias=True,
        tie_embeddings=True,
    )
