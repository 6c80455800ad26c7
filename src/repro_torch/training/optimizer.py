"""AdamW with f32 master weights, global-norm clipping and a warmup +
cosine schedule: the JAX package's ``training/optimizer.py`` in PyTorch,
its own update and not ``torch.optim``.

Trees are the param tree's nested dicts. ``adamw_update_`` is the update:
it writes into the master, moments and params' own tensors, for a caller
that discards the old state (the JAX dry-run donates params and optimizer
state to the train step). ``adamw_update`` is its functional form: the
same update on copies, so a tree handed out (a trainer's ``params``, a
patch) stays as it was.

On a mesh (``specs=``, ``mesh=``) the trees hold a rank's shards laid out
by ``specs`` (``param_pspecs``): the global norm sums each leaf's squares
over the axes its spec cuts and counts a replicated leaf once, so every
rank clips alike, and the update, elementwise, runs on the local shards
of the master, m and v.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.common import flatten_with_keystr
from repro_torch.models.common import tree_map as _map
from repro_torch.sharding.local import all_reduce, cuts, group_size
from repro_torch.sharding.rules import P, mesh_sizes


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


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """The L2 norm of every leaf together, summed in the JAX package's leaf
    order. With ``specs`` and ``mesh`` the leaves are a rank's shards: each
    leaf's sum of squares is all-reduced over the axes its spec cuts (one
    all-reduce a set of axes, of every such leaf's sum at once), so a
    replicated leaf is counted once, and every rank gets the norm of the
    whole tree."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for _, x in flatten_with_keystr(tree)]
    if specs is not None:
        sums = _summed_over_cuts(sums, [s for _, s in _spec_leaves(specs)],
                                 mesh)
    total = 0
    for x in sums:
        total = total + x
    return torch.sqrt(total)


def _spec_leaves(specs):
    """``(path, spec)`` in ``flatten_with_keystr``'s order."""
    if isinstance(specs, P):
        return [((), specs)]
    return [((k,) + path, s) for k in sorted(specs)
            for path, s in _spec_leaves(specs[k])]


def _summed_over_cuts(sums, specs, mesh):
    """Each of ``sums`` all-reduced over the mesh axes its spec cuts."""
    axes = [tuple(a for a in mesh_sizes(mesh)
                  if group_size(mesh, a) > 1 and cuts(sp, a))
            for sp in specs]
    out = list(sums)
    for key in sorted(set(axes)):
        if not key:
            continue
        idx = [i for i, a in enumerate(axes) if a == key]
        vec = torch.stack([sums[i] for i in idx])
        for axis in key:
            vec = all_reduce(vec, mesh, axis)
        for j, i in enumerate(idx):
            out[i] = vec[j]
    return out


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


def _step_scalars(cfg: AdamWConfig, grads, opt: OptState, specs=None,
                  mesh=None):
    """(grad norm, clip factor, new step, lr, b1 and b2 corrections)."""
    gnorm = global_norm(grads, specs, mesh)
    # a true division (torch's ``scalar / tensor`` multiplies by the
    # reciprocal, which rounds differently from XLA's divide)
    clip = torch.clamp_max(
        torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9), 1.0)
    step = opt.step + 1
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    return gnorm, clip, step, lr_schedule(cfg, step), b1c, b2c


# elements of one piece of a leaf in ``adamw_update_`` (256 MB in f32)
_PIECE = 1 << 26


def _pieces(t: torch.Tensor):
    """Index slices of ``t`` along dim 0, each of at most ``_PIECE``
    elements but never less than one row."""
    if t.dim() == 0:
        return [slice(None)]
    per_row = max(t.numel() // max(t.shape[0], 1), 1)
    rows = max(_PIECE // per_row, 1)
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def _drop(tree, path) -> None:
    for k in path[:-1]:
        tree = tree[k]
    del tree[path[-1]]


def adamw_update_(cfg: AdamWConfig, grads, opt: OptState, params,
                  param_dtype=torch.bfloat16, specs=None, mesh=None,
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step on ``grads``, written in place: the master, m and v
    leaves of ``opt`` and the leaves of ``params`` are updated in their
    own tensors and returned with a new step and the stats (a params leaf
    not of ``param_dtype`` is replaced by a new one that is, the master
    cast). ``grads`` may hold the backward's own (bf16) gradients: each
    leaf is converted to f32 a piece at a time (a few rows of the leading
    dim, as the ops are elementwise) and removed from ``grads`` once its
    update is written, so no f32 copy of the whole gradient tree is
    made. ``specs``, ``mesh``: the trees are a rank's shards (module
    docstring)."""
    gnorm, clip, step, lr, b1c, b2c = _step_scalars(cfg, grads, opt, specs,
                                                    mesh)
    for path in list(_paths(grads)):
        grad, p = _get(grads, path), _get(params, path)
        # a leaf of another dtype (an f32 SSM leaf among bf16 params) comes
        # back as a new tensor of param_dtype
        own = p.dtype == param_dtype
        p32, m_t, v_t = (_get(t, path) for t in (opt.master, opt.m, opt.v))
        for sl in _pieces(grad):
            g = grad[sl].to(torch.float32) * clip
            m = m_t[sl].mul_(cfg.b1).add_((1 - cfg.b1) * g)
            gg = (1 - cfg.b2) * g
            v = v_t[sl].mul_(cfg.b2).add_(gg.mul_(g))
            del g, gg
            delta = m / b1c
            denom = (v / b2c).sqrt_().add_(cfg.eps)
            delta.div_(denom)
            del denom
            master = p32[sl]
            if _is_matrix(path):
                delta.add_(cfg.weight_decay * master)
            master.sub_(delta.mul_(lr))
            if own:
                p[sl].copy_(master)
        if not own:
            _put(params, path, p32.to(param_dtype))
        _drop(grads, path)
        del grad
    return params, OptState(step, opt.master, opt.m, opt.v), {
        "grad_norm": gnorm, "lr": lr}


def adamw_update(cfg: AdamWConfig, grads, opt: OptState,
                 param_dtype=torch.bfloat16, specs=None, mesh=None,
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_opt_state, stats): ``adamw_update_`` on
    copies of the optimizer state and on new params of ``param_dtype``,
    so ``grads`` and ``opt`` stay as they were."""
    new = OptState(opt.step, *(_map(torch.clone, t)
                               for t in (opt.master, opt.m, opt.v)))
    params = _map(lambda g: torch.empty(g.shape, dtype=param_dtype,
                                        device=g.device), grads)
    return adamw_update_(cfg, _map(lambda g: g, grads), new, params,
                         param_dtype, specs, mesh)
