"""Plain PyTorch version of ``flash_attention``: the masked softmax
attention of the JAX package's ``attention_full``, materialising the
(B, nq, Sq, Sk) scores."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(qpos, kpos, kvalid, window: int = 0):
    """(B, Sq, Sk) bool, True = attendable: causal by position, then the
    sliding window when ``window`` > 0, then key validity."""
    mask = qpos[:, :, None] >= kpos[:, None, :]
    if window:
        mask &= (qpos[:, :, None] - kpos[:, None, :]) < window
    return mask & kvalid[:, None, :]


def attention_ref(q, k, v, qpos, kpos, kvalid, *, window: int = 0):
    """q (B, Sq, nq, hd); k/v (B, Sk, nkv, hd); qpos (B, Sq); kpos, kvalid
    (B, Sk). Returns (B, Sq, nq, hd) in q's dtype.

    Scores are f32 and scaled by hd**-0.5; a masked score is the finite
    -1e30, so a query with no attendable key averages V uniformly."""
    g = q.shape[2] // k.shape[2]
    kk = k.repeat_interleave(g, dim=2)
    vv = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqnh,bsnh->bnqs", q.float(), kk.float()) \
        * q.shape[-1] ** -0.5
    mask = attention_mask(qpos, kpos, kvalid, window)
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnqs,bsnh->bqnh", probs.to(v.dtype), vv)
