"""Architecture configs. Importing this package populates the registry.

``ASSIGNED`` is the reference's list, in its order; the paper's GPT-Neo
pair (``paper_pair``) is registered beside it, as in the reference."""
from repro_torch.configs.base import (ModelConfig, ShapeSpec, INPUT_SHAPES,
                                      get_config, list_configs, for_shape,
                                      supports_shape, smoke_variant,
                                      draft_variant)
from repro_torch.configs import (deepseek_7b, qwen2_moe_a2_7b,  # noqa: F401
                                 seamless_m4t_large_v2, granite_3_8b,
                                 stablelm_12b, xlstm_1_3b,
                                 deepseek_v2_lite_16b, qwen2_vl_72b,
                                 jamba_1_5_large_398b, qwen2_5_3b,
                                 paper_pair)

ASSIGNED = [
    "deepseek-7b", "qwen2-moe-a2.7b", "seamless-m4t-large-v2",
    "granite-3-8b", "stablelm-12b", "xlstm-1.3b", "deepseek-v2-lite-16b",
    "qwen2-vl-72b", "jamba-1.5-large-398b", "qwen2.5-3b",
]
