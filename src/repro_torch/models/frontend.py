"""Modality frontend stubs: the JAX package's ``models/frontend.py``.

The ``vision`` and ``audio`` architectures specify the transformer
backbone only; these stubs produce embeddings and codec tokens of the
right shapes, so that their prefix-embedding paths run end to end without
a real ViT or EnCodec. The random bits are torch's, drawn from the
caller's ``torch.Generator`` on its device; the result lands on
``device`` (the CUDA device unless the caller passes "cpu", or "meta" for
shapes alone).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device

# llava-next anyres tiling: a 672x672 image -> 4 tiles + base = 5 * 576
VISION_PATCHES_PER_IMAGE = 2880
# EnCodec at 50 Hz frames
AUDIO_FRAMES_PER_SECOND = 50


def frontend_prefix_len(cfg: ModelConfig, seq_len: int) -> int:
    """How many positions of an input of ``seq_len`` are frontend embeds."""
    if cfg.frontend == "vision":
        return min(VISION_PATCHES_PER_IMAGE, seq_len // 2)
    if cfg.frontend == "audio":
        # musicgen conditions on a text/melody prompt embedding prefix
        return min(64, seq_len // 8)
    return 0


def _stub_embeds(gen, batch, n, d_model, dtype, device):
    device = resolve_device(device)
    draw_on = "meta" if device.type == "meta" else gen.device
    x = torch.randn((batch, n, d_model), generator=gen, dtype=torch.float32,
                    device=draw_on)
    return (x.to(dtype) * 0.02).to(device)


def vision_stub_embeds(gen: torch.Generator, batch: int, n_patches: int,
                       d_model: int, dtype=torch.bfloat16, device="cuda"):
    """Stand-in for SigLIP/ViT + projector output (patch embeddings)."""
    return _stub_embeds(gen, batch, n_patches, d_model, dtype, device)


def audio_stub_embeds(gen: torch.Generator, batch: int, n_frames: int,
                      d_model: int, dtype=torch.bfloat16, device="cuda"):
    """Stand-in for the conditioning encoder output (T5/melody features)."""
    return _stub_embeds(gen, batch, n_frames, d_model, dtype, device)


def encodec_stub_tokens(gen: torch.Generator, batch: int, n_frames: int,
                        vocab: int = 2048, device="cuda"):
    """Stand-in for EnCodec RVQ codes (single-stream)."""
    device = resolve_device(device)
    draw_on = "meta" if device.type == "meta" else gen.device
    return torch.randint(0, vocab, (batch, n_frames), generator=gen,
                         dtype=torch.int32, device=draw_on).to(device)
