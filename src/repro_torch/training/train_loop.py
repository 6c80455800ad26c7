"""The train step: the forward on its plain path, autograd, microbatch
gradient accumulation and AdamW (the JAX package's
``training/train_loop.py`` on one device).

The forward runs with ``use_kernels=False``, as the JAX package trains
through plain XLA attention and the plain SSD scan: the CUDA kernels have
no backward, and their wrappers raise when asked for gradients.
``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does there. The JAX
config's sharding fields and ``q_chunk`` mean nothing on one device and
are left out. ``make_train_step(..., donate=True)`` updates the params
and the optimizer state in their own tensors (``adamw_update_``), as the
JAX dry-run donates them to its train step; the step layer
(``launch/steps.py``) and ``launch/train.py`` train that way.

``TrainConfig(mesh=...)`` trains on a ("data", "model") mesh (FSDP x TP):
the params and optimizer state are the rank's shards in the training
layout (``param_pspecs(cfg, mesh)``) and the batch the rank's rows of a
batch cut over ``data``. The forward gathers each block's FSDP-cut
weights over ``data`` and runs the model-axis code with gradients
through its collectives (``models/model.py``); the loss and the MoE aux
loss are means over the whole batch; after the backward pass the
gradient of each leaf that ``data`` does not cut is summed over it (an
FSDP-cut leaf's is reduce-scattered in the backward pass), and the
global norm and AdamW run on the shards (``training/optimizer.py``).
Microbatch ``i`` is the JAX one: global rows ``[i*B/nm, (i+1)*B/nm)``,
each then cut over ``data``. With ``mesh=None`` the step is the
one-device step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import flatten_with_keystr
from repro_torch.models.common import tree_map as _map
from repro_torch.models.model import _forward
from repro_torch.sharding.local import (all_reduce, cuts, dp_axes,
                                        gather_rows, group_size,
                                        shard_block)
from repro_torch.sharding.rules import param_pspecs
from repro_torch.training.losses import cross_entropy
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                           adamw_update, adamw_update_)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    # the batch is split into `microbatches` sequential accumulation steps
    microbatches: int = 1
    remat: bool = True
    param_dtype: torch.dtype = torch.bfloat16
    # a ("data", "model") DeviceMesh: train on its ranks' shards
    mesh: Any = None


def make_loss_fn(model_cfg: ModelConfig, train_cfg: TrainConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``; ``batch`` holds
    ``tokens`` (B,St), ``labels`` (B,S) and optionally ``prefix_embeds``
    (B,Sp,d) in front of the tokens (S = Sp + St) and ``valid`` and
    ``loss_mask`` (B,S) tensors; a frontend batch's ``loss_mask`` is
    False on the prefix positions. The metrics are the mean loss, the
    accuracy and the MoE load-balance loss summed over the layers (0
    without MoE), which the returned loss includes. On a mesh the params
    are the rank's shards and the batch its rows (module docstring)."""
    mesh = train_cfg.mesh
    on_mesh = {} if mesh is None else {
        "mesh": mesh, "specs": param_pspecs(model_cfg, mesh)}

    def loss_fn(params, batch):
        logits, aux = _forward(params, model_cfg, batch["tokens"],
                               prefix_embeds=batch.get("prefix_embeds"),
                               valid=batch.get("valid"), use_kernels=False,
                               remat=train_cfg.remat, **on_mesh)
        loss, acc = cross_entropy(logits, batch["labels"],
                                  batch.get("loss_mask", batch.get("valid")),
                                  mesh)
        return loss + aux, {"loss": loss, "acc": acc, "moe_aux": aux}
    return loss_fn


def _mesh_microbatches(batch, nm: int, mesh):
    """The rank's rows of each of the ``nm`` JAX microbatches: the batch
    (the rank's block of rows) gathered over ``data``, cut into ``nm``
    runs of global rows, each cut over ``data`` again."""
    whole = {k: gather_rows(v, mesh) for k, v in batch.items()}
    out = []
    for i in range(nm):
        mb = {}
        for k, v in whole.items():
            part = v.reshape((nm, v.shape[0] // nm) + v.shape[1:])[i]
            mb[k] = part[shard_block(part.shape[0], dp_axes(mesh), mesh)]
        out.append(mb)
    return out


def sum_over_data(grads, specs, mesh) -> None:
    """Each gradient whose leaf the data axes do not cut, summed over
    them in place: a rank's holds its rows' part."""
    dp = dp_axes(mesh)
    if group_size(mesh, dp) == 1:
        return
    for k, g in grads.items():
        if isinstance(g, dict):
            sum_over_data(g, specs[k], mesh)
        elif not cuts(specs[k], dp):
            grads[k] = all_reduce(g, mesh, dp)


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = torch.as_tensor(v).to(device)
    return out


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, *,
                    donate: bool = False) -> Callable:
    """``train_step(params, opt, batch) -> (params, opt, metrics)``. The
    batch (numpy arrays or tensors) moves to the params' device; with
    ``microbatches`` > 1 it is split along the batch axis and the f32
    gradients are summed over the pieces and divided by their count, as
    the JAX step's scan does.

    ``donate``: the step owns ``params`` and ``opt``. It writes the update
    into their tensors and returns them (with a new step count), and the
    caller must not use the old ``params``/``opt`` as they were; without
    it the update goes to copies (``adamw_update``). Either way, with one
    microbatch no f32 copy of the whole gradient tree is made: each
    leaf's gradient is converted a piece at a time and dropped once its
    update is written.

    ``train_cfg.mesh``: the step on a rank's shards (module docstring)."""
    loss_fn = make_loss_fn(model_cfg, train_cfg)
    mesh = train_cfg.mesh
    specs = None if mesh is None else param_pspecs(model_cfg, mesh)

    def grad_fn(params, batch):
        live = _map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, batch)
            loss.backward()
        grads = _map(lambda p: torch.zeros_like(p) if p.grad is None
                     else p.grad, live)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(params, opt: OptState, batch):
        device = next(p for _, p in flatten_with_keystr(params)).device
        batch = _to_device(batch, device)
        nm = train_cfg.microbatches
        if nm == 1:
            grads, metrics = grad_fn(params, batch)
        else:
            micro = ([{k: v.reshape((nm, v.shape[0] // nm) + v.shape[1:])[i]
                       for k, v in batch.items()} for i in range(nm)]
                     if mesh is None else
                     _mesh_microbatches(batch, nm, mesh))
            grads = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
            metrics = {k: torch.zeros((), dtype=torch.float32, device=device)
                       for k in ("loss", "acc", "moe_aux")}
            for mb in micro:
                g, m = grad_fn(params, mb)
                _map(lambda a, b: a.add_(b.to(torch.float32)), grads, g)
                del g
                metrics = {k: metrics[k] + m[k] for k in metrics}
            _map(lambda g: g.div_(nm), grads)
            metrics = {k: v / nm for k, v in metrics.items()}
        if mesh is not None:
            sum_over_data(grads, specs, mesh)
        if donate:
            params, opt, stats = adamw_update_(train_cfg.adamw, grads, opt,
                                               params, train_cfg.param_dtype,
                                               specs, mesh)
        else:
            params, opt, stats = adamw_update(train_cfg.adamw, grads, opt,
                                              train_cfg.param_dtype, specs,
                                              mesh)
        return params, opt, {**metrics, **stats}

    return train_step


def train(model_cfg: ModelConfig, train_cfg: TrainConfig, params,
          opt: OptState, batches, *, log_every: int = 20,
          log: Optional[Callable[[str], None]] = print,
          donate: bool = False) -> Dict[str, Any]:
    """Simple host loop over an iterable of batches. Returns the final
    params, optimizer state and per-step metrics. ``donate``: the steps
    update ``params`` and ``opt`` in their own tensors."""
    step_fn = make_train_step(model_cfg, train_cfg, donate=donate)
    history = []
    for i, batch in enumerate(batches):
        params, opt, metrics = step_fn(params, opt, batch)
        m = {k: float(v) for k, v in metrics.items()}
        if log and (i % log_every == 0):
            log(f"step {i:5d} loss={m['loss']:.4f} acc={m['acc']:.4f} "
                f"gnorm={m['grad_norm']:.2f} lr={m['lr']:.2e}")
        history.append(m)
    return {"params": params, "opt": opt, "history": history}
