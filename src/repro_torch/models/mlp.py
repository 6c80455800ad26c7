"""SwiGLU MLP."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import scaled_init


def init_mlp(gen, d_model: int, d_ff: int, dtype, device):
    return {
        "gate": scaled_init(gen, (d_model, d_ff), d_model, dtype, device),
        "up": scaled_init(gen, (d_model, d_ff), d_model, dtype, device),
        "down": scaled_init(gen, (d_ff, d_model), d_ff, dtype, device),
    }


def mlp(params, x):
    g = x @ params["gate"]
    u = x @ params["up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["down"]
