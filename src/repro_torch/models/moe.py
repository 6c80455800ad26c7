"""Mixture-of-Experts MLP with sort-based capacity dispatch (the JAX
package's ``models/moe.py`` on one device).

Tokens are routed into fixed-capacity per-expert buffers through an argsort
permutation, per batch row ("dropping" style: a token past its expert's
capacity gets no output from that expert). Every buffer has a fixed size
and no step reads a value back to the host, so the layer runs inside the
engine's captured slate graph.

The reference's semantics are kept exactly:

- expert choice is a stable descending sort of the router probabilities
  (``jax.lax.top_k`` puts the lower expert first on ties; ``torch.topk``
  does not promise an order);
- dispatch order is a stable argsort of the chosen experts, so the same
  tokens are dropped;
- dropped pairs are written to one overflow row past the buffers, which is
  never read back: the combine gathers from the expert outputs with a zero
  row appended;
- the combine weights are ``top_p / max(sum, 1e-9)`` in f32, cast to the
  activations' dtype before the sum over k; ``silu`` is taken in f32.

The expert products are plain ``einsum``s, as in the reference. Router
jitter is left out: the reference adds it only when given a key, and no
caller of its model passes one.

On a mesh (``moe_apply(..., mesh=)``) the router and the dispatch run on
every rank alike (the router is replicated), so every rank drops the same
tokens. The rank holds a block of the experts (expert parallelism, when
the experts divide the model axis) or a d_ff block of every expert; it
runs only that, and the combined output's partial sums are all-reduced
over the model axis. Under autograd the expert buffers and the combine
weights enter that cut part through ``grad_sum``, so the router, which
every rank computes alike, gets the whole gradient on every rank. With
``aux_over_data`` the rows are the rank's block of a batch cut over the
data axis, and the load-balance loss takes its means over the whole
batch (its sums all-reduced over ``data``), as the JAX loss does on the
global batch.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import scaled_init
from repro_torch.sharding.local import (dp_axes, group_size, grad_sum,
                                        reduce_sum, shard_block)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device
             ) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "router": scaled_init(gen, (d, e), d, torch.float32, device),
        "gate": scaled_init(gen, (e, d, f), d, dtype, device),
        "up": scaled_init(gen, (e, d, f), d, dtype, device),
        "down": scaled_init(gen, (e, f, d), f, dtype, device),
    }


def moe_capacity(seq: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    return max(1, -(-int(seq * m.top_k * m.capacity_factor) // m.n_experts))


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, mesh=None,
              aux_over_data: bool = False,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d), load-balance aux loss, an f32 scalar).
    ``mesh``: the expert weights are the rank's shards; ``aux_over_data``:
    the aux loss over the data-cut batch (module docstring)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    c = moe_capacity(s, cfg)

    logits = torch.einsum("bsd,de->bse", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)  # (B,S,E)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]  # (B,S,K)
    top_w = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # ---- sort-based dispatch, per batch row --------------------------
    sk = s * k
    e_flat = top_e.reshape(b, sk)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    sorted_e = torch.gather(e_flat, 1, order)
    # position within each expert's run of the sorted id list
    idx = torch.arange(sk, device=x.device)[None, :].expand(b, sk)
    is_start = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                     device=x.device),
                          sorted_e[:, 1:] != sorted_e[:, :-1]], dim=-1)
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    pos_in_expert = idx - run_start
    dest = torch.where(pos_in_expert >= c, e * c,
                       sorted_e * c + pos_in_expert)  # overflow bin e*c

    tok_idx = order // k  # (B, SK) source token of each sorted (token,k) pair
    x_sorted = torch.gather(x, 1, tok_idx[..., None].expand(b, sk, d))
    # the overflow row takes every dropped pair (an arbitrary one wins)
    # and is never read back
    buf = torch.zeros((b, e * c + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, dest[..., None].expand(b, sk, d), x_sorted)
    expert_in = buf[:, :e * c].reshape(b, e, c, d)

    # ---- per-expert SwiGLU -------------------------------------------
    e_local = params["gate"].shape[0]
    cut = e_local != e or params["down"].shape[1] != cfg.d_ff
    if cut:
        expert_in = grad_sum(expert_in, mesh)
        top_w = grad_sum(top_w, mesh)
    if e_local != e:  # expert parallelism: the rank's experts only
        expert_in = expert_in[:, shard_block(e, "model", mesh)]
    g = torch.einsum("becd,edf->becf", expert_in, params["gate"])
    u = torch.einsum("becd,edf->becf", expert_in, params["up"])
    h = F.silu(g.float()).to(x.dtype) * u
    expert_out = torch.einsum("becf,efd->becd", h, params["down"])
    if e_local != e:  # the other ranks' experts contribute zeros here
        full = torch.zeros((b, e, c, d), dtype=x.dtype, device=x.device)
        full[:, shard_block(e, "model", mesh)] = expert_out
        expert_out = full

    # ---- gather back + combine ---------------------------------------
    flat = torch.cat([expert_out.reshape(b, e * c, d),
                      torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)],
                     dim=1)
    y_sorted = torch.gather(flat, 1, dest[..., None].expand(b, sk, d))
    y_flat = torch.zeros((b, sk, d), dtype=x.dtype, device=x.device)
    y_flat.scatter_(1, order[..., None].expand(b, sk, d), y_sorted)
    y = (y_flat.reshape(b, s, k, d) * top_w[..., None].to(x.dtype)).sum(2)
    if cut:
        y = reduce_sum(y, mesh)

    # ---- Switch-style load balance loss ------------------------------
    experts = torch.arange(e, device=x.device)
    assign = (top_e[..., :1] == experts).float()  # top-1 fraction
    dp = dp_axes(mesh)
    if aux_over_data and group_size(mesh, dp) > 1:
        rows = b * s * group_size(mesh, dp)
        f_e = reduce_sum(assign.sum(dim=(0, 1)), mesh, dp) / rows
        p_e = reduce_sum(probs.sum(dim=(0, 1)), mesh, dp) / rows
    else:
        f_e = assign.mean(dim=(0, 1))
        p_e = probs.mean(dim=(0, 1))
    aux = e * torch.sum(f_e * p_e) * m.load_balance_coef
    return y, aux
