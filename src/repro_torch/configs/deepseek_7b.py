"""DeepSeek-LLM-7B: dense llama-arch, MHA (GQA kv=32) [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_7b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", family="dense", source="arXiv:2401.02954",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=11008, vocab=102400, rope_theta=1e4,
    )
