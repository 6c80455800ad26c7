"""Sharding rules: ModelConfig x mesh -> partition-spec trees (the JAX
package's ``sharding/rules.py``, in pure Python).

2-D "FSDP x TP" layout:

* the ``data`` axis (plus the outer ``pod`` axis on multi-pod meshes)
  shards the batch and, FSDP-style, the d_model dimension of weight
  matrices;
* the ``model`` axis is tensor parallelism: attention heads (or head_dim
  when the head count does not divide), MLP d_ff, MoE experts (or expert
  d_ff), SSM heads, and the embedding's d_model.

Every rule degrades to replication when a dimension does not divide the
axis size, so every shard of a leaf has the same shape.

The functions return trees of :class:`P` matching the trees of
``models.model.param_shapes`` and ``cache_shapes``. A mesh is anything with
``axis_names`` and a ``shape`` mapping of axis name to size (the JAX
package's meshes, :class:`MeshShape`), or a torch ``DeviceMesh``, read
through ``mesh_dim_names`` and ``size(i)``. Nothing here touches a
process group: ``sharding/local.py`` cuts the shards and runs the
collectives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``
    (replicated), an axis name, or a tuple of axis names (the dim is split
    over their product). Entries are normalised as JAX's ``PartitionSpec``
    normalises them: a one-name tuple becomes the name, an empty one
    ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """An abstract mesh: axis sizes and names, no devices (the JAX
    package's ``AbstractMesh``)."""
    sizes: Tuple[int, ...]
    names: Tuple[str, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh: a ``DeviceMesh`` or anything with
    ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # torch DeviceMesh
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def data_axes(mesh) -> Tuple[str, ...]:
    """The (super-)data axes: ("pod", "data") on multi-pod, else ("data",)."""
    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved layout decisions for one (config, mesh) pair."""
    cfg: ModelConfig
    dp: Tuple[str, ...]        # data axes (batch / FSDP)
    tp: Optional[str]          # model axis
    dp_size: int
    tp_size: int
    # resolved choices
    attn_heads_on_tp: bool     # heads vs head_dim on the model axis
    moe_experts_on_tp: bool    # expert axis vs expert-d_ff on the model axis

    @classmethod
    def make(cls, cfg: ModelConfig, mesh,
             decode: bool = False) -> "ShardingRules":
        dp = data_axes(mesh)
        tp = "model" if "model" in mesh_sizes(mesh) else None
        tpn = axis_size(mesh, tp) if tp else 1
        # In decode mode the attention layout must match the KV cache's,
        # or every layer re-gathers the cache each token. The cache shards
        # kv heads when they divide tp, else head_dim, so q and o follow
        # the same rule in decode mode.
        heads_on_tp = (_div(cfg.n_kv_heads, tpn) if decode
                       else _div(cfg.n_heads, tpn))
        return cls(
            cfg=cfg, dp=dp, tp=tp, dp_size=axis_size(mesh, dp), tp_size=tpn,
            attn_heads_on_tp=heads_on_tp,
            moe_experts_on_tp=(cfg.moe is not None
                               and _div(cfg.moe.n_experts, tpn)),
        )

    # -- helpers ---------------------------------------------------------
    def fsdp(self, dim: int):
        """Shard a d_model-like dim over the data axes when it divides."""
        return self.dp if _div(dim, self.dp_size) else None

    def tpa(self, dim: int):
        return self.tp if _div(dim, self.tp_size) else None


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------

def _attn_specs(r: ShardingRules, stacked: bool):
    cfg = r.cfg
    lead = (None,) if stacked else ()
    hd, nkv, d = cfg.head_dim_, cfg.n_kv_heads, cfg.d_model
    if r.attn_heads_on_tp:
        q_spec = P(*lead, r.fsdp(d), r.tp, None)
        o_spec = P(*lead, r.tp, None, r.fsdp(d))
        bq = P(*lead, r.tp, None)
    else:  # shard head_dim instead
        q_spec = P(*lead, r.fsdp(d), None, r.tpa(hd))
        o_spec = P(*lead, None, r.tpa(hd), r.fsdp(d))
        bq = P(*lead, None, r.tpa(hd))
    # KV projections stay replicated over tp unless the kv heads divide it
    kv_spec = (P(*lead, r.fsdp(d), r.tp, None) if _div(nkv, r.tp_size)
               else P(*lead, r.fsdp(d), None, None))
    bkv = (P(*lead, r.tp, None) if _div(nkv, r.tp_size)
           else P(*lead, None, None))
    specs = {"wq": q_spec, "wk": kv_spec, "wv": kv_spec, "wo": o_spec}
    if cfg.qkv_bias:
        specs.update({"bq": bq, "bk": bkv, "bv": bkv})
    return specs


def _ssm_specs(r: ShardingRules, stacked: bool):
    cfg = r.cfg
    lead = (None,) if stacked else ()
    d, din, nh = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
    din_tp = r.tpa(din)
    nh_tp = r.tpa(nh)
    return {
        "wz": P(*lead, r.fsdp(d), din_tp),
        "wx": P(*lead, r.fsdp(d), din_tp),
        "wB": P(*lead, r.fsdp(d), None),   # B/C shared across heads
        "wC": P(*lead, r.fsdp(d), None),
        "wdt": P(*lead, r.fsdp(d), nh_tp),
        "conv_x": P(*lead, None, din_tp),
        "conv_B": P(*lead, None, None),
        "conv_C": P(*lead, None, None),
        "conv_bias_x": P(*lead, din_tp),
        "conv_bias_B": P(*lead, None),
        "conv_bias_C": P(*lead, None),
        "A_log": P(*lead, nh_tp),
        "D": P(*lead, nh_tp),
        "dt_bias": P(*lead, nh_tp),
        "norm_scale": P(*lead, din_tp),
        "out_proj": P(*lead, din_tp, r.fsdp(d)),
    }


def _moe_specs(r: ShardingRules, stacked: bool):
    cfg = r.cfg
    lead = (None,) if stacked else ()
    d, f = cfg.d_model, cfg.d_ff
    if r.moe_experts_on_tp:  # expert parallelism over the model axis
        up = P(*lead, r.tp, r.fsdp(d), None)
        down = P(*lead, r.tp, None, r.fsdp(d))
    else:  # TP inside each expert
        up = P(*lead, None, r.fsdp(d), r.tpa(f))
        down = P(*lead, None, r.tpa(f), r.fsdp(d))
    return {"router": P(*lead, r.fsdp(d), None),
            "gate": up, "up": up, "down": down}


def _mlp_specs(r: ShardingRules, stacked: bool):
    cfg = r.cfg
    lead = (None,) if stacked else ()
    d, f = cfg.d_model, cfg.d_ff
    return {"gate": P(*lead, r.fsdp(d), r.tpa(f)),
            "up": P(*lead, r.fsdp(d), r.tpa(f)),
            "down": P(*lead, r.tpa(f), r.fsdp(d))}


def param_pspecs(cfg: ModelConfig, mesh, decode: bool = False) -> Any:
    """Spec tree matching ``models.model.init_params``."""
    from repro_torch.models.model import pattern_sig
    r = ShardingRules.make(cfg, mesh, decode=decode)
    vp, d = cfg.vocab_padded, cfg.d_model
    # The embedding is stored d-sharded (vocab replicated), so the token
    # gather stays local; an untied head is stored vocab-sharded, so the
    # logits shard over tp.
    embed = P(None, r.tpa(d))
    head = P(r.tpa(vp), None)

    blocks = {}
    for p, (kind, mlp_kind) in enumerate(pattern_sig(cfg)):
        lp: dict = {"norm1": {"scale": P(None, None)}}
        if kind == "attn":
            lp["attn"] = _attn_specs(r, stacked=True)
        else:
            lp["ssm"] = _ssm_specs(r, stacked=True)
        if mlp_kind != "none":
            lp["norm2"] = {"scale": P(None, None)}
        if mlp_kind == "dense":
            lp["mlp"] = _mlp_specs(r, stacked=True)
        elif mlp_kind == "moe":
            lp["moe"] = _moe_specs(r, stacked=True)
        blocks[f"pos{p}"] = lp

    specs = {"embed": {"table": embed}, "blocks": blocks,
             "final_norm": {"scale": P(None)}}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"table": head}
    return specs


def head_pspec(cfg: ModelConfig, mesh) -> P:
    """The layout of the logits matmul's table: vocab on the model axis."""
    r = ShardingRules.make(cfg, mesh)
    return P(r.tpa(cfg.vocab_padded), None)


# ----------------------------------------------------------------------
# Activations / caches / optimizer
# ----------------------------------------------------------------------

def batch_pspec(mesh, global_batch: int) -> P:
    """Tokens/labels (B, S): batch over the data axes when it divides."""
    dp = data_axes(mesh)
    return P(dp if _div(global_batch, axis_size(mesh, dp)) else None, None)


def _kv_model_specs(r: ShardingRules):
    """(kv-head spec, head_dim spec) of a K/V cache leaf: kv heads on the
    model axis when they divide it, else head_dim when that divides."""
    cfg = r.cfg
    kv_on_tp = _div(cfg.n_kv_heads, r.tp_size)
    return (r.tp if kv_on_tp else None,
            None if kv_on_tp else r.tpa(cfg.head_dim_))


def cache_pspecs(cfg: ModelConfig, mesh, batch: int,
                 decode: bool = True) -> Any:
    """Decode-cache spec tree matching ``init_cache``.

    The leading dim of every leaf is the layer repeat R. Attention K/V are
    (R, B, W, nkv, hd): batch over data when it divides, else the capacity
    dim W shards over data (long_500k, batch 1). SSM states (R, B, nh, hp,
    ds): batch over data, heads over model.
    """
    from repro_torch.models.model import pattern_sig
    r = ShardingRules.make(cfg, mesh, decode=decode)
    b_on_dp = _div(batch, r.dp_size)
    bspec = r.dp if b_on_dp else None
    wspec = None if b_on_dp else r.dp  # capacity shards when batch can't
    kv_tp, hd_tp = _kv_model_specs(r)

    out = {}
    for p, (kind, _) in enumerate(pattern_sig(cfg)):
        if kind == "attn":
            kv = P(None, bspec, wspec, kv_tp, hd_tp)
            out[f"pos{p}"] = {"k": kv, "v": kv,
                              "valid": P(None, bspec, wspec)}
        else:
            out[f"pos{p}"] = _ssm_cache_specs(r, bspec)
    return out


def _ssm_cache_specs(r: ShardingRules, bspec):
    cfg = r.cfg
    return {
        "conv_x": P(None, bspec, None, r.tpa(cfg.d_inner)),
        "conv_B": P(None, bspec, None, None),
        "conv_C": P(None, bspec, None, None),
        "state": P(None, bspec, r.tpa(cfg.n_ssm_heads), None, None),
    }


def _seq_specs(cfg: ModelConfig, mesh, bspec_of) -> Any:
    """Sequence-form cache specs with the batch spec ``bspec_of(rules)``."""
    from repro_torch.models.model import pattern_sig
    r = ShardingRules.make(cfg, mesh, decode=True)
    bspec = bspec_of(r)
    kv_tp, hd_tp = _kv_model_specs(r)
    out = {}
    for p, (kind, _) in enumerate(pattern_sig(cfg)):
        if kind == "attn":
            kv = P(None, bspec, None, kv_tp, hd_tp)
            out[f"pos{p}"] = {"k": kv, "v": kv}
        else:
            out[f"pos{p}"] = _ssm_cache_specs(r, bspec)
    return out


def seq_cache_pspecs(cfg: ModelConfig, mesh, batch: int) -> Any:
    """Spec tree for **sequence-form** caches, the tree ``prefill`` and
    ``extend`` return (and ``extend`` consumes).

    Like :func:`cache_pspecs`, but attention layers carry only ``{"k",
    "v"}`` of shape (R, B, S, nkv, hd): the pad mask travels separately as
    the engine state's ``valid`` (B, S). Batch (axis 1 of every leaf)
    shards over the data axes; heads or d_inner shard over the model axis
    exactly as in the ring layout, so ``finalize`` is local.
    """
    return _seq_specs(cfg, mesh,
                      lambda r: r.dp if _div(batch, r.dp_size) else None)


@dataclasses.dataclass(frozen=True)
class SlotPoolShardings:
    """Specs of the paged prefill-state pool (serving/pool.py)."""
    caches: Any          # tree of P matching seq-form caches, slot axis 1
    valid: P             # (n_slots, S)
    rows: P              # (n_slots,)
    logits: P            # (n_slots, Vp)


def slot_pool_pspecs(cfg: ModelConfig, mesh) -> SlotPoolShardings:
    """Specs of the device-resident slot pool.

    The pool's slot axis (axis 1 of every cache leaf, axis 0 of the
    valid/next_pos/last_logits planes) is replicated over the data axes,
    never sharded, so that each data shard reads its pane rows from its
    own copy with no collective. Model-axis dims shard exactly as in
    :func:`seq_cache_pspecs`, so a gathered pane lands in the layout
    ``inject`` and ``finalize`` consume.
    """
    return SlotPoolShardings(caches=_seq_specs(cfg, mesh, lambda r: None),
                             valid=P(None, None), rows=P(None),
                             logits=P(None, None))


@dataclasses.dataclass(frozen=True)
class ServingShardings:
    """Every spec the serving engine needs, resolved once.

    ``params`` uses the decode-mode rules (the attention layout must match
    the KV cache's, see ``ShardingRules.make``) with the FSDP data-axis
    factor **stripped**: serving replicates weights across data-parallel
    replicas and shards only the request batch and caches over ``data``
    (FSDP would re-gather every weight matrix a layer a token). The
    ``model`` axis is kept. ``tokens``/``rows`` shard the request batch
    over the data axes; ``seq_caches``/``ring_caches`` are the
    prefill/inject and decode cache layouts.
    """
    params: Any          # tree of P matching init_params
    tokens: P            # (B, S) token/valid planes
    rows: P              # (B,) per-row scalars (next_pos / pos)
    logits: P            # (B, S, Vp) and (B, Vp) prefixes
    seq_caches: Any      # tree of P matching prefill/extend caches
    ring_caches: Any     # tree of P matching init_cache/finalize
    data_shards: int     # number of data-parallel shards


def tree_map_specs(fn, tree):
    """``fn`` over the :class:`P` leaves of a nested dict."""
    if isinstance(tree, P):
        return fn(tree)
    return {k: tree_map_specs(fn, v) for k, v in tree.items()}


def _strip_dp(spec: P, dp) -> P:
    """``spec`` with any data-axis factor replaced by replication."""
    def keep(ax):
        axes = ax if isinstance(ax, tuple) else (ax,)
        return None if any(a in dp for a in axes) else ax
    return P(*[keep(ax) for ax in spec])


def serving_param_pspecs(cfg: ModelConfig, mesh) -> Any:
    """The serving layout of the params: the decode-mode rules with the
    FSDP data-axis factor stripped (``ServingShardings.params``)."""
    dp = data_axes(mesh)
    return tree_map_specs(lambda s: _strip_dp(s, dp),
                          param_pspecs(cfg, mesh, decode=True))


def serving_pspecs(cfg: ModelConfig, mesh, max_batch: int,
                   ) -> ServingShardings:
    """The serving path's specs for one engine.

    Raises ``ValueError`` when ``max_batch`` is not a multiple of the
    data-axis size: a pane shards evenly or not at all, and that is
    decided at engine construction.
    """
    dp = data_axes(mesh)
    dpn = axis_size(mesh, dp)
    if max_batch % max(dpn, 1) != 0:
        raise ValueError(
            f"max_batch={max_batch} must be a multiple of the data-axis "
            f"size {dpn} (mesh {mesh_sizes(mesh)}); panes shard evenly or "
            f"not at all")

    return ServingShardings(
        params=serving_param_pspecs(cfg, mesh),
        tokens=batch_pspec(mesh, max_batch),
        rows=P(dp if _div(max_batch, dpn) else None),
        logits=P(dp if _div(max_batch, dpn) else None),
        seq_caches=seq_cache_pspecs(cfg, mesh, max_batch),
        ring_caches=cache_pspecs(cfg, mesh, max_batch),
        data_shards=dpn,
    )


def opt_pspecs(param_specs: Any) -> Any:
    """Optimizer state mirrors the parameter sharding."""
    from repro_torch.training.optimizer import OptState
    return OptState(step=P(), master=param_specs,
                    m=param_specs, v=param_specs)
