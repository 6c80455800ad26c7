"""Decoder-only ranker over a ``ModelConfig`` (dense stacks).

Parameters keep the JAX package's tree (``init_params`` there): per-layer
params stacked as ``blocks["pos{p}"]`` with a leading repeat dim R =
n_layers / P, where P is the period of the layer-kind pattern. The JAX
package scans over the R repeats; here the stack is a loop over them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import normal_init
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.norms import init_rmsnorm, rmsnorm

NEG_INF = -1e30


# ----------------------------------------------------------------------
# Layer pattern
# ----------------------------------------------------------------------

def block_pattern(cfg: ModelConfig) -> int:
    """Smallest period P with n_layers % P == 0 and kinds[i] == kinds[i % P]."""
    sig = list(zip(cfg.layer_kinds(), cfg.mlp_kinds()))
    n = cfg.n_layers
    for p in range(1, n + 1):
        if n % p == 0 and all(sig[i] == sig[i % p] for i in range(n)):
            return p
    return n


def pattern_sig(cfg: ModelConfig):
    p = block_pattern(cfg)
    sig = list(zip(cfg.layer_kinds(), cfg.mlp_kinds()))
    return sig[:p]


def _check_dense(cfg: ModelConfig) -> None:
    if any(sig != ("attn", "dense") for sig in pattern_sig(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention stacks only so far")


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    return {
        "norm1": init_rmsnorm(cfg.d_model, dtype, device),
        "attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "norm2": init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _stack(trees):
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """Random params with the JAX ``init_params``' paths, shapes and scales.
    The random bits are torch's, not ``jax.random``'s."""
    _check_dense(cfg)
    pat = pattern_sig(cfg)
    R = cfg.n_layers // len(pat)
    blocks = {f"pos{p}": _stack([_init_layer(generator, cfg, dtype, device)
                                 for _ in range(R)])
              for p in range(len(pat))}
    params = {
        "embed": {"table": normal_init(generator,
                                       (cfg.vocab_padded, cfg.d_model),
                                       cfg.d_model ** -0.5, dtype, device)},
        "blocks": blocks,
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": normal_init(
            generator, (cfg.vocab_padded, cfg.d_model), cfg.d_model ** -0.5,
            dtype, device)}
    return params


def param_shapes(cfg: ModelConfig):
    """The param tree's shapes (no allocation)."""
    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    return shapes(init_params(cfg, torch.Generator(), torch.float32, "meta"))


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------

def _take(tree, r: int):
    """Repeat ``r`` of a stacked param tree (dict or nn.ModuleDict)."""
    return {k: v[r] if isinstance(v, torch.Tensor) else _take(v, r)
            for k, v in tree.items()}


def _layer(lp, x, positions, valid, cfg: ModelConfig):
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    mix, _ = attn_mod.attention_full(lp["attn"], h, positions, cfg,
                                     valid=valid)
    x = x + mix
    h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    return x + mlp(lp["mlp"], h)


def _logits(params, cfg: ModelConfig, x):
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["table"])
    logits = torch.einsum("bsd,vd->bsv", x, table).float()
    if cfg.vocab_padded != cfg.vocab_size:
        vmask = torch.arange(cfg.vocab_padded, device=x.device) \
            < cfg.vocab_size
        logits = torch.where(vmask, logits, NEG_INF)
    return logits


def forward(params, cfg: ModelConfig, tokens, *, positions=None, valid=None,
            last_only: bool = False) -> torch.Tensor:
    """Logits (B, S, Vp) fp32, or (B, 1, Vp) of the last position alone
    with ``last_only`` (same values: norm and head are per position).

    tokens (B,S) int; positions (B,S) or (S,), default 0..S-1; valid (B,S)
    bool key mask (left padding)."""
    _check_dense(cfg)
    b, s = tokens.shape
    x = params["embed"]["table"][tokens.long()]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    pat = pattern_sig(cfg)
    for r in range(cfg.n_layers // len(pat)):
        for p in range(len(pat)):
            x = _layer(_take(params["blocks"][f"pos{p}"], r), x, positions,
                       valid, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x)


def _as_module(tree) -> nn.Module:
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _as_module(v) for k, v in tree.items()})


class Ranker(nn.Module):
    """The ranker as an ``nn.Module``. ``params`` holds the param tree as
    nested ``ModuleDict``/``ParameterDict``s over the same tensors, so its
    ``state_dict`` keys are the JAX paths joined by dots."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        _check_dense(cfg)
        self.cfg = cfg
        self.params = _as_module(params)

    def forward(self, tokens, *, positions=None, valid=None,
                last_only: bool = False) -> torch.Tensor:
        return forward(self.params, self.cfg, tokens, positions=positions,
                       valid=valid, last_only=last_only)
