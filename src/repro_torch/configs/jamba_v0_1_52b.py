"""Config module for --arch selection (see archs.py for the definition)."""
from repro_torch.configs.archs import JAMBA_52B as CONFIG  # noqa: F401
