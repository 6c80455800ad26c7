"""Config module for --arch selection (see archs.py for the definition)."""
from repro_torch.configs.archs import COMMAND_R_PLUS as CONFIG  # noqa: F401
