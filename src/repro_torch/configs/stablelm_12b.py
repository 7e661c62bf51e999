"""StableLM-2-12B: dense GQA kv=8 [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig, register


@register
def stablelm_12b() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
        d_ff=13824, vocab=100352, rope_theta=1e4,
    )
