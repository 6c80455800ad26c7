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
1.7 TB for ``musicgen-large``).

``make_step_and_specs`` builds the same steps on a ("data", "model")
mesh (``launch/mesh.py``; an abstract ``MeshShape`` for ``device="meta"``,
on which the step runs as the dry run, ``launch/dryrun.py``)
and returns, besides the step and a rank's example args, the in- and
out-specs: the port's ``P`` trees that equal the ``.spec`` of the JAX
``make_step_and_specs``' ``NamedSharding``s leaf for leaf. Train and
prefill take the params in the training layout (``param_pspecs``, FSDP
kept), decode in the decode layout with FSDP kept, as the JAX module
does; the caches and batches are laid out by ``cache_pspecs``,
``_prefill_cache_pspecs`` and ``batch_pspec``.

The JAX module's three GSPMD hints have no counterpart, and need none:
they steer where XLA places data and do not change values.
``_activation_shardings`` asks GSPMD to keep the layer-boundary
activations batch-cut and model-cut, and the logits and head vocab-cut;
here the layout is the one the rules choose, written out in the layers:
activations replicated over ``model`` between layers, each layer's
model-axis collectives at its entry and exit, the logits gathered before
the loss (``models/model.py``). ``_attn_pad_policy`` pads the head axis
to a multiple of ``model`` where ``n_heads`` does not divide it (llava's
56 heads, granite's 24) so that GSPMD shards the scores; the rules then
cut head_dim instead, and the layers run every head on a head_dim block
(``models/attention.py``), so nothing is padded. ``_moe_use_shardings``
states the expert weights' layout at use, after the FSDP gather; here
each block gathers its FSDP-cut leaves over ``data`` on entry and then
holds exactly the rules' model-axis layout (``models/moe.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models.common import resolve_device
from repro_torch.models.frontend import (audio_stub_embeds,
                                         frontend_prefix_len,
                                         vision_stub_embeds)
from repro_torch.models.model import (cache_shapes, decode_step, init_cache,
                                      init_params, pattern_sig, prefill)
from repro_torch.serving.engine import make_serve_step
from repro_torch.sharding.local import (all_gather, dp_axes, group_size,
                                        local_shape, local_shard, mesh_sizes,
                                        shard_block, shard_tree)
from repro_torch.sharding.rules import (P, ShardingRules, _ssm_cache_specs,
                                        batch_pspec, cache_pspecs, data_axes,
                                        opt_pspecs, param_pspecs)
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


# ----------------------------------------------------------------------
# On a mesh
# ----------------------------------------------------------------------

METRICS = ("loss", "acc", "moe_aux", "grad_norm", "lr")


def _local_meta(tree, specs, mesh):
    """Meta tensors of a rank's block of each leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _local_meta(v, specs[k], mesh) for k, v in tree.items()}
    return torch.empty(local_shape(tree.shape, specs, mesh),
                       dtype=tree.dtype, device="meta")


def abstract_params(cfg: ModelConfig, mesh, decode: bool = False,
                    dtype=torch.bfloat16):
    """(a rank's params as meta tensors, their specs): the training
    layout, or the decode rules with ``decode``, FSDP kept either way."""
    specs = param_pspecs(cfg, mesh, decode=decode)
    whole = init_params(cfg, torch.Generator(), dtype, "meta")
    return _local_meta(whole, specs, mesh), specs


def abstract_opt(cfg: ModelConfig, mesh, dtype=torch.bfloat16):
    """(a rank's optimizer state as meta tensors, its specs)."""
    params, specs = abstract_params(cfg, mesh, dtype=dtype)
    opt = init_opt_state(params)
    return opt, opt_pspecs(specs)


def _batch_specs(cfg: ModelConfig, shape: InputShape, mesh, b: int,
                 with_labels: bool):
    """The specs of ``make_batch``'s tree: rows over ``data`` where they
    divide it, the prefix embeddings as the tokens."""
    bspec = batch_pspec(mesh, b)
    specs = {"tokens": bspec}
    if frontend_prefix_len(cfg, shape.seq_len):
        specs["prefix_embeds"] = P(bspec[0], None, None)
    if with_labels:
        specs["labels"] = bspec
        if "prefix_embeds" in specs:
            specs["loss_mask"] = bspec
    return specs


def _prefill_cache_pspecs(cfg: ModelConfig, mesh, batch: int):
    """The specs of the prefill step's sequence-form caches: K/V (R, B, S,
    nkv, hd) with head_dim on ``model`` where it divides, the SSM leaves
    as in the decode cache."""
    r = ShardingRules.make(cfg, mesh)
    bspec = r.dp if batch % r.dp_size == 0 else None
    hd_tp = r.tpa(cfg.head_dim_)
    out = {}
    for p, (kind, _) in enumerate(pattern_sig(cfg)):
        if kind == "attn":
            kv = P(None, bspec, None, None, hd_tp)
            out[f"pos{p}"] = {"k": kv, "v": kv}
        else:
            out[f"pos{p}"] = _ssm_cache_specs(r, bspec)
    return out


def _relayout(x: torch.Tensor, have: P, want: P, mesh) -> torch.Tensor:
    """A rank's block of a tensor laid out by ``have``, laid out by
    ``want`` instead: each dim cut otherwise is all-gathered over its
    axis, then cut by ``want``."""
    for dim, (h, w) in enumerate(zip(have, want)):
        if h == w:
            continue
        if h is not None:
            x = all_gather(x, mesh, h, dim)
        if w is not None:
            x = x.narrow(dim, shard_block(x.shape[dim], w, mesh).start,
                         x.shape[dim] // mesh_sizes(mesh)[w]).contiguous()
    return x


def _mesh_args(cfg, mesh, device, dtype, gen, *, decode=False):
    """A rank's params (drawn whole a layer at a time from ``gen``, each
    rank keeping its block) and their specs; meta tensors on "meta"."""
    if device.type == "meta":
        return abstract_params(cfg, mesh, decode=decode, dtype=dtype)
    specs = param_pspecs(cfg, mesh, decode=decode)
    return init_params(cfg, gen, dtype, device, mesh=mesh,
                       specs=specs), specs


def _local_batch(cfg, b, s, bspecs, mesh, *, with_labels, device, gen):
    """A rank's rows of ``make_batch``'s global batch."""
    whole = make_batch(cfg, b, s, with_labels=with_labels, device=device,
                       generator=gen)
    if device.type == "meta":
        return _local_meta(whole, bspecs, mesh)
    return shard_tree(whole, bspecs, mesh)


def make_step_and_specs(cfg: ModelConfig, shape: InputShape, mesh, *,
                        batch: Optional[int] = None, device="cuda",
                        dtype=torch.bfloat16,
                        generator: Optional[torch.Generator] = None,
                        ) -> Tuple[Callable, Tuple, Any, Any]:
    """``(step_fn, example_args, in_specs, out_specs)`` for ``shape``'s
    kind on a ("data", "model") ``mesh``, the JAX ``make_step_and_specs``
    with ``P`` trees for its shardings' specs (module docstring):

    - train: ``train_step(params, opt, batch) -> (params, opt, metrics)``
      on the rank's shards (``TrainConfig(mesh=mesh)``, donating, AdamW
      defaults, remat, ``microbatches_for`` with the mesh's sizes);
    - prefill: ``prefill_step(params, batch) -> (the rank's vocab block of
      the last position's logits (B, Vp / model), caches)``, the caches
      laid out by ``_prefill_cache_pspecs``;
    - decode: ``serve_step(params, caches, tokens, pos) -> (next_token,
      caches)``, which writes into the rank's caches.

    Example args: the rank's blocks of what ``make_step_and_inputs``
    gives for the global batch ``batch`` (default the shape's), drawn in
    the same order from the same generator, so a 1x1 mesh's args and
    results are bit for bit the one-device step's. On "meta" nothing is
    allocated and ``mesh`` may be an abstract ``MeshShape``, a multi-pod
    one of ("pod", "data", "model") included; the step then runs on the
    meta args, its collectives and kernels taking their abstract routes
    (``sharding/local.py``, the kernel wrappers' meta routes), which is
    the dry run (``launch/dryrun.py``)."""
    device = resolve_device(device)
    cfg = arch_for_shape(cfg, shape)
    b = shape.global_batch if batch is None else batch
    gen = generator if generator is not None else _generator(device)
    if shape.kind == "train":
        return _train_setup(cfg, shape, mesh, b, device, dtype, gen)
    if shape.kind == "prefill":
        return _prefill_setup(cfg, shape, mesh, b, device, dtype, gen)
    return _decode_setup(cfg, shape, mesh, b, device, dtype, gen)


def _train_setup(cfg, shape, mesh, b, device, dtype, gen):
    sizes = mesh_sizes(mesh)
    dp = group_size(mesh, dp_axes(mesh))
    if b % dp:
        raise ValueError(f"a global batch of {b} does not split over the "
                         f"{dp} data ranks")
    local = dataclasses.replace(shape, global_batch=b)
    tcfg = TrainConfig(adamw=AdamWConfig(),
                       microbatches=microbatches_for(cfg, local, dp=dp,
                                                     tp=sizes["model"]),
                       remat=True, param_dtype=dtype, mesh=mesh)
    step = make_train_step(cfg, tcfg, donate=True)
    params, pspecs = _mesh_args(cfg, mesh, device, dtype, gen)
    bspecs = _batch_specs(cfg, shape, mesh, b, with_labels=True)
    data = _local_batch(cfg, b, shape.seq_len, bspecs, mesh,
                        with_labels=True, device=device, gen=gen)
    ospecs = opt_pspecs(pspecs)
    return (step, (params, init_opt_state(params), data),
            (pspecs, ospecs, bspecs),
            (pspecs, ospecs, {k: P() for k in METRICS}))


def _prefill_setup(cfg, shape, mesh, b, device, dtype, gen):
    params, pspecs = _mesh_args(cfg, mesh, device, dtype, gen)
    bspecs = _batch_specs(cfg, shape, mesh, b, with_labels=False)
    data = _local_batch(cfg, b, shape.seq_len, bspecs, mesh,
                        with_labels=False, device=device, gen=gen)
    dp = data_axes(mesh)
    rows = bspecs["tokens"][0]
    logits_spec = P(dp, "model")
    cache_specs = _prefill_cache_pspecs(cfg, mesh, b)
    nkv, hd = cfg.n_kv_heads, cfg.head_dim_

    def prefill_step(params, batch):
        logits, caches = prefill(
            params, cfg, batch["tokens"],
            prefix_embeds=batch.get("prefix_embeds"),
            logits_last_only=True, mesh=mesh, specs=pspecs)
        logits = _relayout(logits[:, 0], P(rows, None), logits_spec, mesh)
        for key, want in cache_specs.items():
            if "k" not in want:
                continue
            for name in ("k", "v"):
                t = caches[key][name]
                have = P(None, rows, None,
                         None if t.shape[3] == nkv else "model",
                         None if t.shape[4] == hd else "model")
                caches[key][name] = _relayout(t, have, want[name], mesh)
        return logits, caches

    return (prefill_step, (params, data), (pspecs, bspecs),
            (logits_spec, cache_specs))


def _local_cache(cfg, b, capacity, specs, mesh, dtype, device):
    """A rank's block of ``init_cache(cfg, b, capacity)``, allocated at its
    own shape: zeros, the ring validity ones."""
    def fill(meta, spec, name):
        shape = local_shape(meta.shape, spec, mesh)
        make = torch.ones if name == "valid" else torch.zeros
        return make(shape, dtype=meta.dtype, device=device)

    whole = cache_shapes(cfg, b, capacity, dtype)
    return {key: {name: fill(t, specs[key][name], name)
                  for name, t in leaves.items()}
            for key, leaves in whole.items()}


def _decode_setup(cfg, shape, mesh, b, device, dtype, gen):
    params, pspecs = _mesh_args(cfg, mesh, device, dtype, gen, decode=True)
    cspecs = cache_pspecs(cfg, mesh, b)
    caches = _local_cache(cfg, b, shape.seq_len, cspecs, mesh, dtype, device)
    bspec = batch_pspec(mesh, b)
    tokens = make_batch(cfg, b, 1, with_labels=False, device=device,
                        generator=gen)["tokens"]
    pos = torch.full((b,), shape.seq_len, dtype=torch.int32, device=device)
    if device.type == "meta":
        tokens = _local_meta(tokens, bspec, mesh)
        pos = _local_meta(pos, P(bspec[0]), mesh)
    else:
        tokens = local_shard(tokens, bspec, mesh)
        pos = local_shard(pos, P(bspec[0]), mesh)
    # a batch that does not split over data leaves the ring's slots cut
    # over it instead (cache_pspecs): each layer gathers its own
    ring_cut = bspec[0] is None and group_size(mesh, dp_axes(mesh)) > 1

    def serve_step(params, caches, tokens, pos):
        logits, caches = decode_step(params, cfg, caches, tokens, pos,
                                     inplace=True, mesh=mesh, specs=pspecs,
                                     cache_specs=cspecs if ring_cut else None)
        return torch.argmax(logits[:, 0], dim=-1).to(torch.int32), caches

    return (serve_step, (params, caches, tokens, pos),
            (pspecs, cspecs, bspec, P(bspec[0])), (P(bspec[0]), cspecs))

