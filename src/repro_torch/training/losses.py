"""Next-token / next-item cross-entropy with padded-vocab and validity
masking (the JAX package's ``training/losses.py``)."""
from __future__ import annotations

import torch

from repro_torch.sharding.local import dp_axes, group_size, reduce_sum


def cross_entropy(logits, labels, valid=None, mesh=None):
    """logits (B,S,Vp) f32 (the padded vocab already masked to -1e30);
    labels (B,S) int; valid (B,S) bool or int. Returns (mean loss,
    accuracy) over the valid positions, as 0-dim f32 tensors.

    The label's logit is gathered: the JAX package contracts a one-hot
    instead (for sharded vocabularies), which adds only exact zeros, so
    the two give the same value.

    ``mesh``: the rows are this rank's block of a batch cut over the
    mesh's data axis. The sums and counts are then all-reduced over it,
    so every rank returns the mean over the whole batch, whatever its own
    count of valid positions; the gradient reaching the rank's logits is
    that of the whole batch's mean."""
    labels = labels.long()
    logz = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - lab
    hit = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    dp = dp_axes(mesh)
    if group_size(mesh, dp) > 1:
        w = (torch.ones_like(nll) if valid is None
             else valid.to(torch.float32))
        denom = torch.clamp_min(reduce_sum(w.sum(), mesh, dp), 1.0)
        return (reduce_sum((nll * w).sum(), mesh, dp) / denom,
                reduce_sum((hit * w).sum(), mesh, dp) / denom)
    if valid is None:
        return nll.mean(), hit.mean()
    w = valid.to(torch.float32)
    denom = torch.clamp_min(w.sum(), 1.0)
    return (nll * w).sum() / denom, (hit * w).sum() / denom
