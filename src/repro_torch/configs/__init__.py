from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
    get_config,
    get_reduced_config,
    list_configs,
)
