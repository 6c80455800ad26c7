"""SwiGLU MLP."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import scaled_init
from repro_torch.sharding.local import grad_sum, reduce_sum


def init_mlp(gen, d_model: int, d_ff: int, dtype, device):
    return {
        "gate": scaled_init(gen, (d_model, d_ff), d_model, dtype, device),
        "up": scaled_init(gen, (d_model, d_ff), d_model, dtype, device),
        "down": scaled_init(gen, (d_ff, d_model), d_ff, dtype, device),
    }


def mlp(params, x, mesh=None, d_ff=None):
    """On a mesh the rank holds a d_ff block of ``gate``/``up`` (columns)
    and ``down`` (rows) when the block is smaller than ``d_ff``; its
    partial output is then all-reduced over the model axis (and, under
    autograd, the gradient of ``x`` too)."""
    cut = mesh is not None and params["down"].shape[0] != d_ff
    if cut:
        x = grad_sum(x, mesh)
    g = x @ params["gate"]
    u = x @ params["up"]
    h = F.silu(g.float()).to(x.dtype) * u
    y = h @ params["down"]
    if cut:
        y = reduce_sum(y, mesh)
    return y
