from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, get_config, list_configs, pad_vocab,
    reduced, register,
)
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape  # noqa: F401
