"""Step functions and example inputs for every (arch x input shape), on
one device: the JAX package's ``launch/steps.py`` without its mesh.

Step kinds per input shape (``configs/shapes.py``):
  train_4k     -> train_step   (forward+backward+AdamW, remat, microbatched;
                  params and optimizer state donated)
  prefill_32k  -> prefill_step (history -> decode cache + last-token logits)
  decode_32k   -> serve_step   (ONE token against a seq_len KV cache,
                  which it updates in place)
  long_500k    -> serve_step   (512k context; a dense arch without a window
                  gets the sliding-window ring cache, ``arch_for_shape``)

[vlm]/[audio] archs: ``prefix_embeds`` stand in for the stubbed frontend
(``models/frontend.py``): patch/frame embeddings of the right shape occupy
the leading positions.

``make_step_and_inputs(..., device="meta")`` gives example args that are
shapes and dtypes only, nothing allocated (the dry-run's use); on "cpu"
or "cuda" they are real tensors drawn from the caller's generator.
``batch=`` replaces the shape's global batch, since one card holds a
local batch, not the pod's (``decode_32k``'s 128 x 32768 cache alone is
1.7 TB for ``musicgen-large``). The mesh-only parts of the JAX module
(shardings, head padding, the MoE use-shardings) wait for a device mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models.common import resolve_device
from repro_torch.models.frontend import (audio_stub_embeds,
                                         frontend_prefix_len,
                                         vision_stub_embeds)
from repro_torch.models.model import init_cache, init_params, prefill
from repro_torch.serving.engine import make_serve_step
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_loop import TrainConfig, make_train_step

# Sliding window substituted for pure full-attention archs at long_500k
# (full attention at 512k is excluded by the assignment).
LONG_CONTEXT_WINDOW = 4096


def microbatches_for(cfg: ModelConfig, shape: InputShape,
                     act_budget: float = 1.5 * 2**30,
                     dp: int = 16, tp: int = 16) -> int:
    """Gradient-accumulation factor from an activation-memory budget: the
    smallest power of two whose remat-saved layer-boundary activations
    (B/(dp*mb) rows x L x S x d x 2 B / tp) fit the budget."""
    bytes_row = cfg.n_layers * shape.seq_len * cfg.d_model * 2 / tp
    rows = shape.global_batch / dp
    mb = 1
    while mb < rows and rows / mb * bytes_row > act_budget:
        mb *= 2
    return mb


def arch_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape config adjustments (the long_500k SWA substitution)."""
    if (shape.name == "long_500k" and cfg.ssm is None
            and not cfg.sliding_window):
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, *,
               with_labels: bool, device="cuda", generator=None):
    """A step's batch as the JAX ``_batch_specs`` lays it out: ``tokens``
    (b, s - pfx) int32, and for a frontend arch ``prefix_embeds`` (b, pfx,
    d_model) bf16 with pfx = ``frontend_prefix_len``; with labels,
    ``labels`` (b, s) int32 and, with a prefix, ``loss_mask`` (b, s) bool,
    False on the prefix positions. Tokens and labels are drawn from
    [1, vocab), the embeddings from the frontend stub."""
    device = resolve_device(device)
    gen = generator if generator is not None else _generator(device)
    b, s = batch, seq_len
    pfx = frontend_prefix_len(cfg, s)

    def ints(shape):
        if device.type == "meta":
            return torch.empty(shape, dtype=torch.int32, device=device)
        return torch.randint(1, cfg.vocab_size, shape, generator=gen,
                             dtype=torch.int32, device=gen.device).to(device)

    out = {"tokens": ints((b, s - pfx))}
    if pfx:
        stub = vision_stub_embeds if cfg.frontend == "vision" \
            else audio_stub_embeds
        out["prefix_embeds"] = stub(gen, b, pfx, cfg.d_model,
                                    torch.bfloat16, device)
    if with_labels:
        out["labels"] = ints((b, s))
        if pfx:
            mask = torch.ones((b, s), dtype=torch.bool, device=device)
            mask[:, :pfx] = False
            out["loss_mask"] = mask
    return out


def _generator(device: torch.device) -> Optional[torch.Generator]:
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(0)


def make_step_and_inputs(cfg: ModelConfig, shape: InputShape, *,
                         batch: Optional[int] = None, device="cuda",
                         dtype=torch.bfloat16,
                         generator: Optional[torch.Generator] = None,
                         ) -> Tuple[Callable, Tuple]:
    """``(step_fn, example_args)`` for ``shape``'s kind, on one device:

    - train: ``train_step(params, opt, batch) -> (params, opt, metrics)``,
      which donates ``params`` and ``opt`` (``make_train_step(...,
      donate=True)``), AdamW defaults, remat, ``microbatches_for`` with
      dp = tp = 1 at the local batch;
    - prefill: ``prefill_step(params, batch) -> (logits of the last
      position (B, Vp), caches)``;
    - decode: ``serve_step(params, caches, tokens (B,1), pos (B,)) ->
      (next_token (B,), caches)`` (``make_serve_step``), which writes into
      the caches it is given, as the dry-run donates them.

    Example args: params of ``dtype`` (``init_params``), for train the
    optimizer state (step 0, f32 master and moments), the batch
    (``make_batch``), and for decode an empty ring cache of ``seq_len``
    slots (the window's, where the arch has one) of ``dtype`` with one
    token a row at position ``seq_len``. ``batch`` replaces the shape's
    global batch. ``device="meta"`` allocates nothing; otherwise
    ``generator`` (default: seed 0 on ``device``) draws the weights and
    data."""
    device = resolve_device(device)
    cfg = arch_for_shape(cfg, shape)
    b = shape.global_batch if batch is None else batch
    gen = generator if generator is not None else _generator(device)
    params = init_params(cfg, gen if gen is not None else torch.Generator(),
                         dtype, device)
    if shape.kind == "train":
        local = dataclasses.replace(shape, global_batch=b)
        tcfg = TrainConfig(adamw=AdamWConfig(),
                           microbatches=microbatches_for(cfg, local, dp=1,
                                                         tp=1),
                           remat=True, param_dtype=dtype)
        step = make_train_step(cfg, tcfg, donate=True)
        data = make_batch(cfg, b, shape.seq_len, with_labels=True,
                          device=device, generator=gen)
        return step, (params, init_opt_state(params), data)
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            logits, caches = prefill(
                params, cfg, batch["tokens"],
                prefix_embeds=batch.get("prefix_embeds"),
                logits_last_only=True)
            return logits[:, 0], caches

        data = make_batch(cfg, b, shape.seq_len, with_labels=False,
                          device=device, generator=gen)
        return prefill_step, (params, data)
    caches = init_cache(cfg, b, shape.seq_len, dtype, device)
    tokens = make_batch(cfg, b, 1, with_labels=False, device=device,
                        generator=gen)["tokens"]
    pos = torch.full((b,), shape.seq_len, dtype=torch.int32, device=device)
    return make_serve_step(cfg), (params, caches, tokens, pos)
