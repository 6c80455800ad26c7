"""RMSNorm (scale-only), computed in fp32 for stability."""
from __future__ import annotations

import torch


def init_rmsnorm(dim: int, dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)
