"""Config module for --arch selection (see archs.py for the definition)."""
from repro_torch.configs.archs import MIXTRAL_8X22B as CONFIG  # noqa: F401
