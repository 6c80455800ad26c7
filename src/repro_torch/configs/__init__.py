from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, SSMConfig, get_config, list_configs, pad_vocab, reduced,
    register,
)
