"""Config module for --arch selection (see archs.py for the definition)."""
from repro_torch.configs.archs import DEEPSEEK_67B as CONFIG  # noqa: F401
