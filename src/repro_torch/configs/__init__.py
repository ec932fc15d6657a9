from repro_torch.configs.base import (
    ALL_ARCH_IDS,
    ModelConfig,
    get_config,
    reduced_config,
)
