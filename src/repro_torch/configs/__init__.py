from repro_torch.configs.base import ModelConfig, get_config  # noqa: F401
