"""Config module for --arch selection (see archs.py for the definition)."""
from repro_torch.configs.archs import PAPER_RANKER as CONFIG  # noqa: F401
