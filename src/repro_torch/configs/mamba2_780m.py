"""Config module for --arch selection (see archs.py for the definition)."""
from repro_torch.configs.archs import MAMBA2_780M as CONFIG  # noqa: F401
