"""Token-level serving: the engine's prefill, inject and decode."""
from repro_torch.serving.engine import ServingConfig, ServingEngine  # noqa: F401
