"""Plain PyTorch version of ``decode_attention``: one query token per row
against the ring KV cache, as the JAX package's ``attention_decode``
computes its masked contraction, materialising the (B, nq, W) scores."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ring_live(pos, stored):
    """(B, W) bool, True = attendable: slot j holds a token iff j <= pos or
    the ring has wrapped (pos >= W), and it was stored (left-padded
    prefill slots stay False)."""
    w = stored.shape[1]
    idx = torch.arange(w, dtype=torch.int32, device=pos.device)[None, :]
    return ((idx <= pos[:, None]) | (pos[:, None] >= w)) & stored


def ring_bias(pos, capacity: int):
    """The JAX kernel's additive mask (``kernels/decode_attention/ops.py``):
    0 where slot i <= pos or the ring has wrapped, -1e30 elsewhere.
    pos (B,) int32 -> (B, capacity) f32."""
    stored = torch.ones((pos.shape[0], capacity), dtype=torch.bool,
                        device=pos.device)
    return torch.where(ring_live(pos, stored), 0.0, NEG_INF).float()


def decode_attention_ref(q, k_cache, v_cache, pos, stored):
    """q (B, 1, nq, hd); k/v cache (B, W, nkv, hd); pos (B,) int32; stored
    (B, W) bool. Returns (B, 1, nq, hd) in q's dtype.

    Scores are f32 and scaled by hd**-0.5; a dead slot's score is the
    finite -1e30. Probabilities are cast to V's dtype before the PV
    product. Query head h reads KV head h // (nq // nkv)."""
    g = q.shape[2] // k_cache.shape[2]
    kk = k_cache.repeat_interleave(g, dim=2)
    vv = v_cache.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqnh,bsnh->bnqs", q.float(), kk.float()) \
        * q.shape[-1] ** -0.5
    live = ring_live(pos, stored)
    scores = torch.where(live[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnqs,bsnh->bqnh", probs.to(v_cache.dtype), vv)
