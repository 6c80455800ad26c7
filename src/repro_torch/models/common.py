"""Shared model utilities: the device rule and the initializers."""
from __future__ import annotations

import math

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist. The
    port's entry points default to ``"cuda"`` and never fall back to the
    CPU on their own: pass ``device="cpu"`` to run there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def normal_init(gen: torch.Generator, shape, std, dtype, device):
    """N(0, std^2) drawn in f32 from ``gen`` (on the generator's device, or
    shape-only on "meta"), then cast to ``dtype`` on ``device``."""
    draw_on = "meta" if torch.device(device).type == "meta" else gen.device
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=draw_on)
    return (x * std).to(dtype=dtype, device=device)


def scaled_init(gen, shape, fan_in, dtype, device):
    return normal_init(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype,
                       device)
