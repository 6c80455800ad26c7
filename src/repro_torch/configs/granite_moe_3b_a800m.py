"""Config module for --arch selection (see archs.py for the definition)."""
from repro_torch.configs.archs import GRANITE_MOE_3B as CONFIG  # noqa: F401
