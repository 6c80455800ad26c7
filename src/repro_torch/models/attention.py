"""GQA self-attention over a full sequence, for a dense single-device stack.

The contraction runs in the ``flash_attention`` op: the hand-written CUDA
kernel on the card, its plain version on the CPU. Masks are built from
positions plus key validity exactly as the JAX package's
``attention_full`` builds them (causal by position, then the sliding
window, then ``valid``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import scaled_init
from repro_torch.models.rope import apply_rope


def init_attention(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    d, nq, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": scaled_init(gen, (d, nq, hd), d, dtype, device),
        "wk": scaled_init(gen, (d, nkv, hd), d, dtype, device),
        "wv": scaled_init(gen, (d, nkv, hd), d, dtype, device),
        "wo": scaled_init(gen, (nq, hd, d), nq * hd, dtype, device),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((heads, hd), dtype=dtype, device=device)
    return p


def _project_qkv(params, x, positions, cfg: ModelConfig):
    """x (B,S,d) -> q (B,S,nq,hd), k/v (B,S,nkv,hd); q,k RoPE-rotated."""
    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, params["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_full(params, x, positions, cfg: ModelConfig, *,
                   valid: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal (optionally sliding-window) self-attention over a full sequence.

    x (B,S,d); positions (S,) or (B,S); valid (B,S) bool key mask. Returns
    (output (B,S,d), {"k", "v"} each (B,S,nkv,hd)).
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, positions, cfg)
    pos = positions.to(torch.int32).expand(b, s).contiguous()
    kvalid = (valid.to(torch.bool).contiguous() if valid is not None
              else torch.ones((b, s), dtype=torch.bool, device=x.device))
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          pos, pos, kvalid,
                          window=cfg.sliding_window)
    y = torch.einsum("bsnh,nhd->bsd", out, params["wo"])
    return y, {"k": k, "v": v}
