"""GQA attention: full-sequence (prefill, extend) and one-token decode
against a ring KV cache, on one device or on a rank's shards.

The contractions run in the ``flash_attention`` and ``decode_attention``
ops: the hand-written CUDA kernels on the card, their plain versions on
the CPU. Masks are built exactly as the JAX package's ``attention_full``
and ``attention_decode`` build them: causal by position, then the sliding
window, then key validity; and for decode the ring validity of each slot.
Keys are stored RoPE-rotated, so a ring overwrite needs no re-rotation.

With a ``mesh`` the params are the rank's shards in the serving layout
(``sharding/rules.py``, decode rules), and the layout is read from their
shapes. Heads on the model axis (the kv heads divide it): the rank runs
the kernel on its own heads against its own cache heads, and the output
projection's partial sums are all-reduced. head_dim on the model axis
(they do not): q is all-gathered to full heads before RoPE, K/V (whose
projections are replicated) are full, the cache holds the rank's
head_dim block and is all-gathered before the kernel, and the rank keeps
its head_dim block of the output for its rows of ``wo``, then all-reduces.

The training layout (``param_pspecs(decode=False)``, FSDP gathered per
layer by the caller) adds one case: heads on the model axis by
``n_heads`` while the kv heads do not divide it, so K/V projections are
replicated. The rank then holds its q heads and every kv head; local q
head ``i`` is global head ``rank * nq_local + i`` and attends to kv head
``global // (n_heads // n_kv_heads)``. Where a rank computes only its
part (its heads or its head_dim block), the layer's input and the
replicated K/V weights enter through ``grad_sum`` and q's gather through
``gather_part``, so that under autograd each rank's gradient of each of
its shards is that block of the one-device gradient
(``sharding/local.py``); without a gradient these are the serving
path's collectives.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.common import scaled_init
from repro_torch.models.rope import apply_rope
from repro_torch.sharding.local import (all_gather, axis_rank, gather_part,
                                        grad_sum, reduce_sum, shard_block)


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


def _project_qkv(params, x, positions, cfg: ModelConfig, mesh=None):
    """x (B,S,d) -> q (B,S,nq,hd), k/v (B,S,nkv,hd); q,k RoPE-rotated.
    On a mesh the heads are the rank's; q is all-gathered to the full
    head_dim when its projection holds a head_dim block."""
    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, params["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if q.shape[-1] != cfg.head_dim_:
        q = gather_part(q, mesh, "model", -1)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _hd_sharded(params, cfg: ModelConfig) -> bool:
    """Whether the rank's ``wo`` holds a head_dim block (head_dim on the
    model axis)."""
    return params["wo"].shape[-2] != cfg.head_dim_


def _out_proj(params, out, cfg: ModelConfig, mesh):
    """The output projection of the attention output (B,S,heads,hd): on a
    mesh the rank's head_dim block of it when ``wo`` holds one, and the
    partial sums all-reduced over the model axis when ``wo`` is cut."""
    if _hd_sharded(params, cfg):
        out = out[..., shard_block(cfg.head_dim_, "model", mesh)]
    y = torch.einsum("bsnh,nhd->bsd", out, params["wo"])
    if _cut(params, cfg):
        y = reduce_sum(y, mesh)
    return y


def _cut(params, cfg: ModelConfig) -> bool:
    """Whether the rank's ``wo`` is a block (heads or head_dim cut over
    the model axis): the layer's work is then split between the ranks."""
    return tuple(params["wo"].shape[:2]) != (cfg.n_heads, cfg.head_dim_)


def _enter(params, x, cfg: ModelConfig, mesh):
    """The layer's input and params as a cut layer uses them: ``x`` and
    the K/V projections that every rank holds whole enter through
    ``grad_sum`` (each rank's gradient of them is its part)."""
    if mesh is None or not _cut(params, cfg):
        return params, x
    params = dict(params)
    for name in ("wk", "wv", "bk", "bv"):
        if name in params and params[name].shape[-2] == cfg.n_kv_heads:
            params[name] = grad_sum(params[name], mesh)
    return params, grad_sum(x, mesh)


def _kv_for_heads(k, v, q_heads: int, cfg: ModelConfig, mesh):
    """K/V (B,S,nkv,hd) of every kv head for a rank that holds ``q_heads``
    of the q heads (the training layout's replicated K/V): one kv head
    for each of its q heads, the one that head attends to, so that the
    kernels' grouping (one q head a kv head) pairs them. Unchanged when
    the rank holds every q head or a block of the kv heads."""
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    if q_heads == nq or k.shape[2] != nkv:
        return k, v
    first = axis_rank(mesh, "model") * q_heads
    sel = torch.tensor([(first + i) // (nq // nkv) for i in range(q_heads)],
                       device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _full_hd(kv, cfg: ModelConfig, mesh):
    """A cache's K or V with the full head_dim (all-gathered when the
    rank holds a block of it)."""
    if kv.shape[-1] == cfg.head_dim_:
        return kv
    return all_gather(kv, mesh, "model", -1)


def attention_full(params, x, positions, cfg: ModelConfig, *,
                   valid: Optional[torch.Tensor] = None,
                   prefix_kv: Optional[Dict[str, torch.Tensor]] = None,
                   prefix_positions: Optional[torch.Tensor] = None,
                   prefix_valid: Optional[torch.Tensor] = None,
                   use_kernel: bool = True, mesh=None,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal (optionally sliding-window) self-attention over a full sequence.

    x (B,S,d); positions (S,) or (B,S); valid (B,S) bool key mask. Returns
    (output (B,S,d), {"k", "v"} each (B,S,nkv,hd)).

    ``prefix_kv``: the K/V of a cached prefix, (B,Sp,nkv,hd) each — the
    incremental prefill of the paper's injection: only the suffix ``x`` is
    computed and its queries attend to prefix + suffix. The prefix keys'
    positions default to their slot indices 0..Sp-1, as in the JAX
    package. The returned K/V cover prefix + suffix.

    ``use_kernel=False`` runs the plain ``attention_ref`` on any device, as
    the JAX package trains through plain XLA attention: the kernel has no
    backward.

    ``mesh``: the params and ``prefix_kv`` are the rank's shards (module
    docstring), and so are the returned K/V.
    """
    b, s, _ = x.shape
    params, x = _enter(params, x, cfg, mesh)
    q, k, v = _project_qkv(params, x, positions, cfg, mesh)
    qpos = positions.to(torch.int32).expand(b, s).contiguous()
    kpos = qpos
    kvalid = (valid.to(torch.bool) if valid is not None
              else torch.ones((b, s), dtype=torch.bool, device=x.device))
    if prefix_kv is not None:
        sp = prefix_kv["k"].shape[1]
        k = torch.cat([_full_hd(prefix_kv["k"], cfg, mesh), k], dim=1)
        v = torch.cat([_full_hd(prefix_kv["v"], cfg, mesh), v], dim=1)
        ppos = (prefix_positions.to(torch.int32) if prefix_positions is not None
                else torch.arange(sp, dtype=torch.int32, device=x.device))
        kpos = torch.cat([ppos.expand(b, sp), kpos], dim=1)
        pval = (prefix_valid.to(torch.bool) if prefix_valid is not None
                else torch.ones((b, sp), dtype=torch.bool, device=x.device))
        kvalid = torch.cat([pval, kvalid], dim=1)
    attend = flash_attention if use_kernel else attention_ref
    kq, vq = _kv_for_heads(k, v, q.shape[2], cfg, mesh)
    out = attend(q.contiguous(), kq.contiguous(), vq.contiguous(), qpos,
                 kpos.contiguous(), kvalid.contiguous(),
                 window=cfg.sliding_window)
    if _hd_sharded(params, cfg):  # the cache keeps the rank's block
        blk = shard_block(cfg.head_dim_, "model", mesh)
        k, v = k[..., blk].contiguous(), v[..., blk].contiguous()
    return _out_proj(params, out, cfg, mesh), {"k": k, "v": v}


# ----------------------------------------------------------------------
# Decode path: ring-buffer KV cache
# ----------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int,
                  dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """One attention layer's empty cache. ``valid`` marks slots holding real
    tokens; it starts all True, as in the JAX package (the position logic
    gates a fresh session)."""
    nkv, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((batch, capacity, nkv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, capacity, nkv, hd), dtype=dtype,
                         device=device),
        "valid": torch.ones((batch, capacity), dtype=torch.bool,
                            device=device),
    }


def cache_from_prefill(kv: Dict[str, torch.Tensor], capacity: int,
                       valid: Optional[torch.Tensor] = None,
                       ) -> Dict[str, torch.Tensor]:
    """A ring decode cache from prefill K/V (B,S,nkv,hd); keeps the trailing
    window when the prefill is longer than ``capacity``. ``valid`` (B,S) is
    the prefill pad mask: each row is first compacted, valid slots to the
    front in their order (a stable sort), so every real entry sits below
    the decode position."""
    k, v = kv["k"], kv["v"]
    b, s = k.shape[:2]
    if valid is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=k.device)
    else:
        valid = valid.to(torch.bool)
        perm = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
        k = torch.take_along_dim(k, perm[:, :, None, None], dim=1)
        v = torch.take_along_dim(v, perm[:, :, None, None], dim=1)
        valid = torch.take_along_dim(valid, perm, dim=1)
    if s >= capacity:
        # ring layout: the entry of position p sits at slot p % capacity;
        # after s tokens the slots hold positions [s - capacity, s)
        shift = s % capacity
        return {"k": torch.roll(k[:, s - capacity:], shift, dims=1),
                "v": torch.roll(v[:, s - capacity:], shift, dims=1),
                "valid": torch.roll(valid[:, s - capacity:], shift, dims=1)}
    pad = capacity - s
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": F.pad(v, (0, 0, 0, 0, 0, pad)),
            "valid": F.pad(valid, (0, pad))}


def attention_decode(params, x, pos, cache, cfg: ModelConfig, *,
                     inplace: bool = False, mesh=None,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode step.

    x (B,1,d); pos (B,) int32, the new token's absolute position (tokens
    already in context); cache {"k", "v"[, "valid"]} with k/v (B,W,nkv,hd).
    Returns (out (B,1,d), updated cache). The new K/V are written to slot
    pos % W before the token attends, so it attends to itself. The
    caller's cache is left as it was unless ``inplace``, which writes into
    it (for a caller that owns the cache and discards the old one).
    ``mesh``: the params and the cache are the rank's shards.
    """
    b = x.shape[0]
    w = cache["k"].shape[1]
    pos = pos.to(torch.int32)
    q, k_new, v_new = _project_qkv(params, x, pos[:, None], cfg, mesh)
    if _hd_sharded(params, cfg):  # the cache holds the rank's block
        blk = shard_block(cfg.head_dim_, "model", mesh)
        k_new, v_new = k_new[..., blk], v_new[..., blk]
    slot = (pos % w).long()
    rows = torch.arange(b, device=x.device)
    stored = cache.get("valid")
    if stored is None:
        stored = torch.ones((b, w), dtype=torch.bool, device=x.device)
    elif not inplace:
        stored = stored.clone()
    k, v = ((cache["k"], cache["v"]) if inplace
            else (cache["k"].clone(), cache["v"].clone()))
    k[rows, slot] = k_new[:, 0]
    v[rows, slot] = v_new[:, 0]
    # a device tensor, not the scalar True: a scalar value is a host copy,
    # which a CUDA graph capture refuses
    stored[rows, slot] = torch.ones_like(slot, dtype=torch.bool)
    out = decode_attention(q.contiguous(), _full_hd(k, cfg, mesh),
                           _full_hd(v, cfg, mesh), pos.contiguous(), stored)
    return _out_proj(params, out, cfg, mesh), {"k": k, "v": v,
                                               "valid": stored}
