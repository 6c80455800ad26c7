"""Decoder-only ranker over a ``ModelConfig``: dense attention stacks,
pure Mamba2 stacks and stacks that mix the two kinds of layer, each with
dense SwiGLU or MoE MLPs. The ``vision`` and ``audio`` archs take the
embeddings of their frontend (``models/frontend.py``) as ``prefix_embeds``
in front of the token embeddings.

Parameters keep the JAX package's tree (``init_params`` there): per-layer
params stacked as ``blocks["pos{p}"]`` with a leading repeat dim R =
n_layers / P, where P is the period of the layer-kind pattern. The JAX
package scans over the R repeats; here the stack is a loop over them.
Caches keep its tree too, each leaf with the leading R dim: attention
positions hold ``{"k", "v"[, "valid"]}``, SSM positions ``{"conv_x",
"conv_B", "conv_C", "state"}`` (conv tails and the f32 recurrent state).

Entry points: ``forward`` (full-sequence logits), ``prefill`` (logits and
the per-layer caches), ``extend`` (the injected suffix against a prefill
cache), ``decode_step`` (one token against the decode caches), and the
cache builders ``init_cache``, ``cache_shapes`` and ``cache_from_prefill``.
Stacked leaves are allocated once at their (R, ...) shape and filled a
repeat at a time, so no layer is held twice.

Every entry point takes an optional ``mesh`` (a ("data", "model")
``DeviceMesh``): the params and caches are then one rank's shards in the
serving layout (``sharding/rules.py``), and the layers insert the
collectives over the model axis that the layout implies (the embedding's
d_model all-gathered, the attention, MLP, MoE and SSM outputs
all-reduced, the vocab-sharded logits all-gathered). Without a mesh,
or on a 1x1 one, the code path is the one-device path.

With ``specs`` as well (a spec tree of ``param_pspecs``, FSDP kept: the
training layout, or the decode rules with FSDP) the params are the
rank's shards in that layout. Each block then gathers its FSDP-cut
leaves over the data axis on entry (``fsdp_gather``), inside the remat
boundary, so a block recomputed in the backward pass gathers again,
and only then runs the layers' model-axis code. Under autograd every
collective has its conjugate (``sharding/local.py``): each rank's
gradient of each of its shards is that block of the one-device
gradient, the data-axis sums aside, which the train step makes
(``training/train_loop.py``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import flatten_with_keystr, normal_init
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.norms import init_rmsnorm, rmsnorm
from repro_torch.sharding.local import (all_gather, cuts, dp_axes,
                                        fsdp_tree, gather_whole, grad_sum,
                                        shard_block, shard_tree)

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


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, kind: str, mlp_kind: str, dtype,
                device) -> Dict[str, Any]:
    p: Dict[str, Any] = {"norm1": init_rmsnorm(cfg.d_model, dtype, device)}
    if kind == "attn":
        p["attn"] = attn_mod.init_attention(gen, cfg, dtype, device)
    else:
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, device)
    if mlp_kind != "none":
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype, device)
    if mlp_kind == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    elif mlp_kind == "moe":
        p["moe"] = init_moe(gen, cfg, dtype, device)
    return p


def _empty_stacked(tree, R: int):
    """Uninitialised (R, ...) leaves of ``tree``'s dtypes and devices."""
    return {k: _empty_stacked(v, R) if isinstance(v, dict)
            else torch.empty((R,) + tuple(v.shape), dtype=v.dtype,
                             device=v.device) for k, v in tree.items()}


def _set_slice(stacked, r: int, tree) -> None:
    """Copy ``tree``'s leaves into repeat ``r`` of ``stacked``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _set_slice(stacked[k], r, v)
        else:
            stacked[k][r].copy_(v)


def _stacked(make, R: int, keep=None):
    """The (R, ...) tree of ``make(0)``, ..., ``make(R - 1)``, called in
    order, each copied into its slice and dropped: what ``torch.stack``
    of the list would give, without holding the list. ``keep`` maps each
    made tree to what is kept of it (a rank's shards). A tree of meta
    tensors holds nothing to copy: its first repeat gives the shapes."""
    out = None
    for r in range(R):
        tree = make(r)
        if keep is not None:
            tree = keep(tree)
        if out is None:
            out = _empty_stacked(tree, R)
            if all(t.is_meta for _, t in flatten_with_keystr(tree)):
                return out
        _set_slice(out, r, tree)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda", mesh=None, specs=None
                ) -> Dict[str, Any]:
    """Random params with the JAX ``init_params``' paths, shapes and scales.
    The random bits are torch's, not ``jax.random``'s: each repeat's layer
    is drawn in turn (f32 draws, one leaf at a time) into its slice of the
    stacked leaves, which are allocated once in ``dtype`` on ``device``.

    With a ``mesh`` the result is this rank's shards in the serving layout
    (``sharding.rules.serving_param_pspecs``): every layer is still drawn
    whole, in the same order from the same generator, and only the rank's
    block of it is kept, so the shards are bit for bit the blocks of the
    unsharded init, and no more than one layer is ever whole. ``specs``
    (a spec tree of the params, such as ``param_pspecs(cfg, mesh)``, the
    training layout) replaces the serving layout."""
    pat = pattern_sig(cfg)
    R = cfg.n_layers // len(pat)
    if mesh is None:
        specs = None
    elif specs is None:
        from repro_torch.sharding.rules import serving_param_pspecs
        specs = serving_param_pspecs(cfg, mesh)

    def keep(tree, spec):
        return tree if spec is None else shard_tree(tree, spec, mesh)

    blocks = {f"pos{p}": _stacked(
        lambda r, kind=kind, mlp_kind=mlp_kind: _init_layer(
            generator, cfg, kind, mlp_kind, dtype, device), R,
        keep=None if specs is None else
        (lambda tree, sp=_layer_specs(specs["blocks"][f"pos{p}"]):
         keep(tree, sp)))
              for p, (kind, mlp_kind) in enumerate(pat)}
    params = {
        "embed": keep({"table": normal_init(
            generator, (cfg.vocab_padded, cfg.d_model), cfg.d_model ** -0.5,
            dtype, device)}, specs and specs["embed"]),
        "blocks": blocks,
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = keep({"table": normal_init(
            generator, (cfg.vocab_padded, cfg.d_model), cfg.d_model ** -0.5,
            dtype, device)}, specs and specs["lm_head"])
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


def _layer(lp, x, positions, valid, cfg: ModelConfig, *, kind="attn",
           mlp_kind="dense", mode="forward", cache=None, prefix_valid=None,
           inplace=False, use_kernels=True, mesh=None, aux_over_data=False):
    """One block. Returns (x, cache_out, aux): cache_out is for "prefill"
    and "extend" the layer's K/V (prefix + suffix) or its SSM tails and
    state, for "decode" its updated cache, None for "forward"; aux is the
    MoE load-balance loss (an f32 scalar), None without an MoE MLP, over
    the whole data-cut batch with ``aux_over_data`` (``moe_apply``)."""
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if kind == "attn" and mode == "decode":
        mix, cache_out = attn_mod.attention_decode(
            lp["attn"], h, positions, cache, cfg, inplace=inplace, mesh=mesh)
    elif kind == "attn":
        mix, cache_out = attn_mod.attention_full(
            lp["attn"], h, positions, cfg, valid=valid,
            prefix_kv=cache if mode == "extend" else None,
            prefix_valid=prefix_valid, use_kernel=use_kernels, mesh=mesh)
    elif mode == "decode":
        mix, cache_out = ssm_mod.ssm_decode(lp["ssm"], h, cache, cfg,
                                            inplace=inplace, mesh=mesh)
    else:
        mix, cache_out = ssm_mod.ssm_forward(
            lp["ssm"], h, cfg, cache=cache if mode == "extend" else None,
            valid=valid, use_kernel=use_kernels, mesh=mesh)
    x = x + mix
    aux = None
    if mlp_kind == "dense":
        x = x + mlp(lp["mlp"], rmsnorm(lp["norm2"], x, cfg.norm_eps), mesh,
                    cfg.d_ff)
    elif mlp_kind == "moe":
        out, aux = moe_apply(lp["moe"], rmsnorm(lp["norm2"], x, cfg.norm_eps),
                             cfg, mesh, aux_over_data)
        x = x + out
    return x, (None if mode == "forward" else cache_out), aux


def _run_stack(params, x, cfg: ModelConfig, *, mode, positions, valid=None,
               caches=None, prefix_valid=None, inplace=False,
               use_kernels=True, remat=False, mesh=None, specs=None,
               cache_specs=None):
    """The R x P blocks in order. Returns (x, caches_out, aux) with
    caches_out stacked over R like the JAX scan's output, or None for
    "forward", and aux the MoE load-balance losses summed over the layers
    in order (an f32 scalar, 0 without MoE), as the JAX scan carries it.
    With ``inplace`` (decode only) the ring writes, conv tails and states
    go into ``caches``' own tensors, which are returned. With ``remat``
    ("forward" only) each block's activations are recomputed in the
    backward pass instead of kept (``torch.utils.checkpoint``). ``specs``:
    the params' layout on ``mesh`` with FSDP (module docstring); each
    block gathers its leaves first, and the MoE aux loss takes its means
    over the data-cut batch. ``cache_specs`` ("decode" only): the caches'
    layout on ``mesh`` where it cuts the ring's slots over the data axis
    (``cache_pspecs`` for a batch that does not split over it); each
    layer then gathers its own slots on entry and keeps its block on
    exit, so no more than one layer's ring is ever whole."""
    pat = pattern_sig(cfg)
    R = cfg.n_layers // len(pat)
    # an attention cache without "valid" gets a new one, so no longer fits
    own = inplace and all(kind == "ssm" or "valid" in caches[f"pos{p}"]
                          for p, (kind, _) in enumerate(pat))
    # caches_out, allocated (R, ...) at each position's first output
    outs = {} if mode != "forward" and not own else None
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(R):
        for p, (kind, mlp_kind) in enumerate(pat):
            key = f"pos{p}"
            cache = None if caches is None else _take(caches[key], r)
            cspecs = None if cache_specs is None else \
                _layer_specs(cache_specs[key])
            kw = dict(positions=positions, valid=valid, cfg=cfg, kind=kind,
                      mlp_kind=mlp_kind, mode=mode,
                      cache=cache if cspecs is None else
                      _gather_slots(cache, cspecs, mesh),
                      prefix_valid=prefix_valid, inplace=inplace,
                      use_kernels=use_kernels, mesh=mesh)
            if specs is None:
                layer = functools.partial(
                    _layer, _take(params["blocks"][key], r), **kw)
            else:
                layer = functools.partial(
                    _fsdp_layer, _take(params["blocks"][key], r),
                    _layer_specs(specs["blocks"][key]), **kw)
            if remat and mode == "forward" and torch.is_grad_enabled():
                x, c_out, aux = checkpoint(layer, x, use_reentrant=False)
            else:
                x, c_out, aux = layer(x)
            del kw, layer
            if cspecs is not None:
                c_out = _keep_slots(cache if own else None, c_out, cspecs,
                                    mesh)
            if outs is not None:
                if key not in outs:
                    outs[key] = _empty_stacked(c_out, R)
                _set_slice(outs[key], r, c_out)
            del c_out
            if aux is not None:
                aux_sum = aux_sum + aux
    if mode == "forward":
        return x, None, aux_sum
    return x, (caches if own else outs), aux_sum


def _layer_specs(specs):
    """One repeat's specs of a stacked block: the leading R entry
    dropped."""
    from repro_torch.sharding.rules import P, tree_map_specs
    return tree_map_specs(lambda sp: P(*sp[1:]), specs)


def _slot_dim(spec):
    """The dim of a cache leaf that ``spec`` cuts over the data axis, if
    any."""
    return next((d for d, e in enumerate(spec) if cuts((e,), "data")),
                None)


def _gather_slots(cache, lspecs, mesh):
    """One layer's cache with each leaf that ``lspecs`` cuts over the data
    axis all-gathered (the whole ring)."""
    return {name: t if _slot_dim(lspecs[name]) is None else
            all_gather(t, mesh, dp_axes(mesh), _slot_dim(lspecs[name]))
            for name, t in cache.items()}


def _keep_slots(own, run, lspecs, mesh):
    """This rank's block of each slot-cut leaf of one layer's updated
    cache ``run``, written into the rank's own leaves ``own`` where
    given; returns the rank's cache."""
    out = {}
    for name, t in run.items():
        dim = _slot_dim(lspecs[name])
        if dim is not None:
            blk = shard_block(t.shape[dim], dp_axes(mesh), mesh)
            t = t.narrow(dim, blk.start, blk.stop - blk.start)
            if own is not None:
                t = own[name].copy_(t)
        out[name] = t
    return out


def _fsdp_layer(lp, lspecs, x, *, mesh, **kw):
    """``_layer`` on the block's leaves gathered over the data axis where
    ``lspecs`` cuts them (inside the remat boundary: a recomputed block
    gathers again), the MoE aux loss over the data-cut batch."""
    return _layer(fsdp_tree(lp, lspecs, mesh), x, mesh=mesh,
                  aux_over_data=True, **kw)


def _logits(params, cfg: ModelConfig, x, mesh=None):
    """Logits (B,S,Vp) f32 of the final hidden states. On a mesh a tied
    table holding a d_model block is all-gathered first; an untied head
    holding a vocab block gives the rank's vocab block of the logits,
    which is all-gathered."""
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["table"])
    if table.shape[1] != cfg.d_model:
        table = gather_whole(table, mesh, "model", 1)
    if table.shape[0] != cfg.vocab_padded:  # each rank its vocab block
        x = grad_sum(x, mesh)
    logits = torch.einsum("bsd,vd->bsv", x, table).float()
    if logits.shape[-1] != cfg.vocab_padded:
        logits = gather_whole(logits, mesh, "model", -1)
    if cfg.vocab_padded != cfg.vocab_size:
        vmask = torch.arange(cfg.vocab_padded, device=x.device) \
            < cfg.vocab_size
        logits = torch.where(vmask, logits, NEG_INF)
    return logits


def _embed(params, tokens, prefix_embeds=None, mesh=None, d_model=None):
    """Token embeddings (B,S,d), after ``prefix_embeds`` (B,Sp,d) cast to
    the table's dtype when given. On a mesh a table holding a block of
    the ``d_model`` columns gathers its block, which is all-gathered over
    the model axis."""
    x = params["embed"]["table"][tokens.long()]
    if mesh is not None and x.shape[-1] != d_model:
        x = gather_whole(x, mesh, "model", -1)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _default_positions(tokens, prefix_embeds):
    """0..S-1 over the prefix and the tokens."""
    s = tokens.shape[1] + (0 if prefix_embeds is None
                           else prefix_embeds.shape[1])
    return torch.arange(s, dtype=torch.int32, device=tokens.device)


def forward(params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
            positions=None, valid=None, last_only: bool = False,
            use_kernels: bool = True, remat: bool = False,
            mesh=None, specs=None) -> torch.Tensor:
    """Logits (B, S, Vp) fp32, or (B, 1, Vp) of the last position alone
    with ``last_only`` (same values: norm and head are per position).

    tokens (B,St) int; prefix_embeds (B,Sp,d) frontend embeddings in front
    of them, S = Sp + St; positions (B,S) or (S,), default 0..S-1; valid
    (B,S) key mask (left padding). ``use_kernels=False`` runs plain
    attention and the plain SSD scan, the path autograd can differentiate
    (the kernels have no backward and raise under grad); ``remat``
    recomputes each block in the backward pass. ``mesh`` and ``specs``:
    the params are a rank's shards (module docstring)."""
    return _forward(params, cfg, tokens, prefix_embeds=prefix_embeds,
                    positions=positions, valid=valid, last_only=last_only,
                    use_kernels=use_kernels, remat=remat, mesh=mesh,
                    specs=specs)[0]


def _forward(params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
             positions=None, valid=None, last_only: bool = False,
             use_kernels: bool = True, remat: bool = False, mesh=None,
             specs=None):
    """``forward``'s (logits, MoE aux loss): the JAX ``forward``'s pair,
    which the training loss reads."""
    if positions is None:
        positions = _default_positions(tokens, prefix_embeds)
    if valid is not None:
        valid = valid.to(torch.bool)    # the training batches' are int32
    x, _, aux = _run_stack(params, _embed(params, tokens, prefix_embeds,
                                          mesh, cfg.d_model),
                           cfg, mode="forward", positions=positions,
                           valid=valid, use_kernels=use_kernels, remat=remat,
                           mesh=mesh, specs=specs)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x, mesh), aux


def prefill(params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
            positions=None, valid=None, logits_last_only: bool = False,
            use_kernels: bool = True, mesh=None, specs=None):
    """Full-sequence pass that also returns the per-layer caches. Returns
    (logits (B,S,Vp) fp32, or (B,1,Vp) with ``logits_last_only``; caches
    {"pos{p}": {"k", "v"}} each (R,B,S,nkv,hd) for attention, the SSM
    tails and state for SSM positions). ``prefix_embeds`` and the default
    positions as in ``forward``; ``use_kernels=False`` runs the plain
    attention and SSD scan; ``mesh`` and ``specs`` as in ``forward``."""
    if positions is None:
        positions = _default_positions(tokens, prefix_embeds)
    x, caches, _ = _run_stack(params, _embed(params, tokens, prefix_embeds,
                                             mesh, cfg.d_model),
                              cfg, mode="prefill", positions=positions,
                              valid=valid, use_kernels=use_kernels, mesh=mesh,
                              specs=specs)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x, mesh), caches


def extend(params, cfg: ModelConfig, caches, tokens, start_pos, *,
           valid=None, prefix_valid=None, mesh=None):
    """Incremental prefill, the paper's injection: run only the ``tokens``
    suffix (B,Ss) against a prefill cache. start_pos (B,) is each row's
    first suffix position; the prefix keys keep their slot indices as
    positions. Returns (logits over the suffix (B,Ss,Vp), caches covering
    prefix + suffix)."""
    positions = start_pos.to(torch.int32)[:, None] + torch.arange(
        tokens.shape[1], dtype=torch.int32, device=tokens.device)[None, :]
    x, caches_out, _ = _run_stack(params, _embed(params, tokens, None, mesh,
                                                 cfg.d_model), cfg,
                                  mode="extend", positions=positions,
                                  valid=valid, caches=caches,
                                  prefix_valid=prefix_valid, mesh=mesh)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x, mesh), caches_out


def decode_step(params, cfg: ModelConfig, caches, tokens, pos, *,
                inplace: bool = False, mesh=None, specs=None,
                cache_specs=None):
    """One-token serve step. tokens (B,1); pos (B,) int32, the number of
    tokens already in the cache (the new token's position). Returns
    (logits (B,1,Vp), updated ring caches). The caller's caches are left
    as they were unless ``inplace``. ``mesh`` and ``specs`` as in
    ``forward``; ``cache_specs``, where the ring's slots are cut over the
    data axis, as in ``_run_stack``."""
    x, caches_out, _ = _run_stack(params, _embed(params, tokens, None, mesh,
                                                 cfg.d_model), cfg,
                                  mode="decode", positions=pos,
                                  caches=caches, inplace=inplace, mesh=mesh,
                                  specs=specs, cache_specs=cache_specs)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x, mesh), caches_out


# ----------------------------------------------------------------------
# Cache construction
# ----------------------------------------------------------------------

def _capacity(cfg: ModelConfig, capacity: int) -> int:
    """KV slots: clamped to the sliding window when the arch has one."""
    return min(capacity, cfg.sliding_window) if cfg.sliding_window \
        else capacity


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, device="cuda"):
    """An empty decode cache with the leading R dim: {"pos{p}": {"k", "v",
    "valid"}} ring caches for attention, zero tails and states for SSM."""
    pat = pattern_sig(cfg)
    R = cfg.n_layers // len(pat)
    caches = {}
    for p, (kind, _) in enumerate(pat):
        if kind == "attn":
            one = attn_mod.init_kv_cache(cfg, batch, _capacity(cfg, capacity),
                                         dtype, device)
        else:
            one = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
        caches[f"pos{p}"] = {k: v[None].repeat((R,) + (1,) * v.dim())
                             for k, v in one.items()}
    return caches


def cache_shapes(cfg: ModelConfig, batch: int, capacity: int,
                 dtype=torch.bfloat16):
    """``init_cache``'s tree as meta tensors: its shapes and dtypes, with
    nothing allocated."""
    return init_cache(cfg, batch, capacity, dtype, "meta")


def cache_from_prefill(cfg: ModelConfig, caches, capacity: int, valid=None,
                       out=None):
    """Prefill (or extend) caches -> decode caches: attention K/V become
    ring caches, SSM tails and states are copied as they are (copies, so
    that an in-place decode leaves the prefill state intact). ``valid``
    (B,S): the pad mask; padded slots stay masked in the ring so decode
    never attends them.

    ``out``: decode caches of the same shapes to write into (the engine's
    graph-owned ring buffers), returned; the SSM leaves are then copied
    once, with no intermediate copy."""
    cap = _capacity(cfg, capacity)
    fresh = {} if out is None else None
    for p, (kind, _) in enumerate(pattern_sig(cfg)):
        key = f"pos{p}"
        kv = caches[key]
        if kind == "attn":
            def ring(r, kv=kv):
                return attn_mod.cache_from_prefill(_take(kv, r), cap, valid)
            if out is None:
                fresh[key] = _stacked(ring, kv["k"].shape[0])
            else:
                for r in range(kv["k"].shape[0]):
                    _set_slice(out[key], r, ring(r))
        elif out is None:
            fresh[key] = {name: t.clone() for name, t in kv.items()}
        else:
            for name, t in kv.items():
                out[key][name].copy_(t)
    return fresh if out is None else out


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
        self.cfg = cfg
        self.params = _as_module(params)

    def forward(self, tokens, *, prefix_embeds=None, positions=None,
                valid=None, last_only: bool = False) -> torch.Tensor:
        return forward(self.params, self.cfg, tokens,
                       prefix_embeds=prefix_embeds, positions=positions,
                       valid=valid, last_only=last_only)

    def prefill(self, tokens, *, prefix_embeds=None, positions=None,
                valid=None, logits_last_only: bool = False):
        return prefill(self.params, self.cfg, tokens,
                       prefix_embeds=prefix_embeds, positions=positions,
                       valid=valid, logits_last_only=logits_last_only)

    def extend(self, caches, tokens, start_pos, *, valid=None,
               prefix_valid=None):
        return extend(self.params, self.cfg, caches, tokens, start_pos,
                      valid=valid, prefix_valid=prefix_valid)

    def decode_step(self, caches, tokens, pos, *, inplace: bool = False):
        return decode_step(self.params, self.cfg, caches, tokens, pos,
                           inplace=inplace)

    def init_cache(self, batch: int, capacity: int):
        table = self.params["embed"]["table"]
        return init_cache(self.cfg, batch, capacity, table.dtype,
                          table.device)

    def cache_from_prefill(self, caches, capacity: int, valid=None):
        return cache_from_prefill(self.cfg, caches, capacity, valid)
