"""AdamW with f32 master weights, global-norm clipping and a warmup +
cosine schedule: the JAX package's ``training/optimizer.py`` in PyTorch,
its own update and not ``torch.optim``.

Trees are the param tree's nested dicts. The update is functional: it
returns new tensors and never writes into the ones it was given, so a
tree handed out (a trainer's ``params``, a patch) stays as it was.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.common import flatten_with_keystr
from repro_torch.models.common import tree_map as _map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    master: Any         # f32 copy of the params
    m: Any
    v: Any


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in float32 as the
    JAX package computes it, unclamped: at ``step == warmup_steps`` it is
    float32's 0.0010000000474974513 for ``lr=1e-3``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> OptState:
    """Step 0, an f32 master copy of ``params`` (always a copy) and zero
    moments."""
    some = next(v for _, v in flatten_with_keystr(params))
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        master=_map(lambda p: p.detach().to(torch.float32, copy=True),
                    params),
        m=_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device), params),
        v=_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device), params))


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together, summed in the JAX package's leaf
    order."""
    total = 0
    for _, x in flatten_with_keystr(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def _is_matrix(path) -> bool:
    """Weight decay applies to matrices only (not norms/biases/A_log/D).
    ``path`` is a leaf's key path, its last key the leaf's name."""
    name = path[-1]
    return name not in ("scale", "norm_scale", "A_log", "D", "dt_bias",
                        "bq", "bk", "bv", "conv_bias_x", "conv_bias_B",
                        "conv_bias_C")


def _paths(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def adamw_update(cfg: AdamWConfig, grads, opt: OptState,
                 param_dtype=torch.bfloat16,
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_opt_state, stats): one AdamW step on f32
    grads, with the master cast to ``param_dtype`` as the new params."""
    gnorm = global_norm(grads)
    # a true division (torch's ``scalar / tensor`` multiplies by the
    # reciprocal, which rounds differently from XLA's divide)
    clip = torch.clamp_max(
        torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9), 1.0)
    step = opt.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    params, master, m_t, v_t = {}, {}, {}, {}
    for path in _paths(grads):
        g = _get(grads, path).to(torch.float32) * clip
        p32 = _get(opt.master, path)
        m = cfg.b1 * _get(opt.m, path) + (1 - cfg.b1) * g
        v = cfg.b2 * _get(opt.v, path) + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if _is_matrix(path):
            delta = delta + cfg.weight_decay * p32
        new = p32 - lr * delta
        _put(master, path, new)
        _put(m_t, path, m)
        _put(v_t, path, v)
        _put(params, path, new.to(param_dtype))
    return params, OptState(step, master, m_t, v_t), {
        "grad_norm": gnorm, "lr": lr}
