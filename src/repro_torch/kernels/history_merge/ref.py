"""Plain PyTorch version of ``history_merge``: the pairwise-rank merge,
vectorised over the batch like the JAX package's ``history_merge_ref``.

The CPU path of ``ops.history_merge`` runs it, and the CUDA kernel is held
against it bit for bit on the card.
"""
from __future__ import annotations

import torch


def history_merge_ref(batch_items, batch_ts, batch_valid, rt_items, rt_ts,
                      rt_valid, *, out_len: int):
    """All inputs (B, L_batch) / (B, L_rt) int32. Returns (items, ts, valid),
    each (B, out_len) int32, right-aligned in ascending time, deduplicated
    by item id (freshest kept, realtime wins timestamp ties)."""
    b, lb = batch_items.shape
    n, k = lb + rt_items.shape[1], out_len
    items = torch.cat([batch_items, rt_items], 1)
    ts = torch.cat([batch_ts, rt_ts], 1)
    valid = torch.cat([batch_valid, rt_valid], 1) > 0
    idx = torch.arange(n, device=items.device)
    is_rt = idx >= lb

    ts_j, ts_i = ts[:, :, None], ts[:, None, :]
    rt_j, rt_i = is_rt[:, None], is_rt[None, :]
    ix_j, ix_i = idx[:, None], idx[None, :]
    fresher = (ts_j > ts_i) | ((ts_j == ts_i) & (
        (rt_j & ~rt_i) | ((rt_j == rt_i) & (ix_j > ix_i))))

    dup = (valid[:, :, None] & (items[:, :, None] == items[:, None, :])
           & fresher).any(1) | ~valid
    alive = ~dup
    rank = (alive[:, :, None] & fresher).sum(1)
    keep = alive & (rank < k)
    tgt = torch.where(keep, k - 1 - rank, k)  # column k = discard bin

    def scatter(src):
        out = torch.zeros((b, k + 1), dtype=torch.int32, device=items.device)
        return out.scatter_(1, tgt, src)[:, :k]

    return scatter(items), scatter(ts), scatter(torch.ones_like(items))
