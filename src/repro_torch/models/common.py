"""Shared model utilities: the device rule, the initializers and the
parameter tree's leaf paths."""
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
    shape-only on "meta"), then cast to ``dtype`` on ``device``. The draw
    is scaled in place: one f32 copy at a time (a 256000 x 12288 head's
    is 12.6 GB)."""
    draw_on = "meta" if torch.device(device).type == "meta" else gen.device
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=draw_on)
    return x.mul_(std).to(dtype=dtype, device=device)


def scaled_init(gen, shape, fan_in, dtype, device):
    return normal_init(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype,
                       device)


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same keys."""
    return {k: tree_map(fn, *(t[k] for t in trees))
            if isinstance(trees[0][k], dict) else fn(*(t[k] for t in trees))
            for k in trees[0]}


def flatten_with_keystr(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a tree of nested dicts (and lists or
    tuples), in ``jax.tree_util.tree_flatten_with_path``'s order (dict keys
    sorted) and with ``jax.tree_util.keystr``'s text for each path:
    ``"['blocks']['pos0']['attn']['wq']"``. The leaf naming that weight
    patches use on both sides (``training/online.py``,
    ``ServingEngine.apply_patch``)."""
    if isinstance(tree, dict):
        items = ((f"[{k!r}]", tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    return [pair for key, v in items
            for pair in flatten_with_keystr(v, prefix + key)]
