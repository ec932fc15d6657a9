from repro_torch.configs.base import (
    ALL_ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    get_config,
    reduced_config,
)
