"""The paper's own experimental pair: GPT-Neo-125M edge draft and
GPT-Neo-1.3B cloud target (EleutherAI), field for field as
``repro.configs.paper_pair``.  Shapes follow the HF model cards; the
weights are trained from scratch on the synthetic corpus
(``repro_torch.launch.train``)."""
from repro_torch.configs.base import ModelConfig, register


@register
def gptneo_125m() -> ModelConfig:
    return ModelConfig(
        name="gptneo-125m", family="dense", source="hf:EleutherAI/gpt-neo-125m",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab=50257, rope_type="none",
    )


@register
def gptneo_1_3b() -> ModelConfig:
    return ModelConfig(
        name="gptneo-1.3b", family="dense", source="hf:EleutherAI/gpt-neo-1.3b",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=8192, vocab=50257, rope_type="none",
    )
