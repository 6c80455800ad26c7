"""Config module for --arch selection (see archs.py for the definition)."""
from repro_torch.configs.archs import LLAVA_NEXT_34B as CONFIG  # noqa: F401
