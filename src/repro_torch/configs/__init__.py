"""Architecture configs. Importing this package populates the registry.

Only the architectures the port runs are registered; the others come
with their model families."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      smoke_variant, draft_variant)
from repro_torch.configs import qwen2_5_3b  # noqa: F401

ASSIGNED = ["qwen2.5-3b"]
