"""Architecture configs. Importing this package populates the registry.

Only the architectures the port runs are registered; the others come
with their model families.  ``ASSIGNED`` is the reference's list; the
paper's GPT-Neo pair (``paper_pair``) is registered beside it, as in the
reference."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      smoke_variant, draft_variant)
from repro_torch.configs import (deepseek_7b, granite_3_8b,  # noqa: F401
                                 jamba_1_5_large_398b, paper_pair,
                                 qwen2_5_3b, qwen2_moe_a2_7b, stablelm_12b,
                                 xlstm_1_3b)

ASSIGNED = ["deepseek-7b", "qwen2-moe-a2.7b", "granite-3-8b",
            "stablelm-12b", "xlstm-1.3b", "jamba-1.5-large-398b",
            "qwen2.5-3b"]
