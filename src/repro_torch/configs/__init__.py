"""Architecture configs. Importing this package populates the registry.

Only the architectures the port runs are registered; the others come
with their model families.  ``ASSIGNED`` is the reference's list; the
paper's GPT-Neo pair (``paper_pair``) is registered beside it, as in the
reference."""
from repro_torch.configs.base import (ModelConfig, ShapeSpec, INPUT_SHAPES,
                                      get_config, list_configs, for_shape,
                                      supports_shape, smoke_variant,
                                      draft_variant)
from repro_torch.configs import (deepseek_7b, granite_3_8b,  # noqa: F401
                                 deepseek_v2_lite_16b, jamba_1_5_large_398b,
                                 paper_pair, qwen2_5_3b, qwen2_moe_a2_7b,
                                 stablelm_12b, xlstm_1_3b)

ASSIGNED = ["deepseek-7b", "qwen2-moe-a2.7b", "granite-3-8b",
            "stablelm-12b", "xlstm-1.3b", "deepseek-v2-lite-16b",
            "jamba-1.5-large-398b", "qwen2.5-3b"]
