"""Mamba2 block: the state-space duality (SSD) mixer of [arXiv:2405.21060].

Per head h, with a (head_dim, d_state) state,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) ⊗ B_t
    y_t = C_t · h_t + D * x_t

``ssm_forward`` runs the chunked scan through ``ops.ssd_scan``: the
hand-written CUDA kernel for CUDA tensors, the plain ``ssd_chunked`` for
CPU tensors (the tensor's device picks, as ``core/injection.py`` does for
the merge). ``ssm_decode`` advances one token with ``ssd_decode_step``,
plain PyTorch, as in the JAX package, which has no kernel for it.

Params and caches keep the JAX package's trees and layouts
(``models/ssm.py`` there); ``A_log``, ``D`` and ``dt_bias`` stay f32 in a
bf16 model, and the state is f32.

On a mesh (``mesh=``) the rank holds a d_inner block of ``wz``, ``wx``,
``conv_x``, ``norm_scale`` and ``out_proj`` and of the x conv tail, and a
head block of ``wdt``, ``A_log``, ``D``, ``dt_bias`` and of the state,
when those dims divide the model axis; ``wB``, ``wC`` and their convs are
replicated. When the head block lines up with the d_inner block the scan
runs on the rank's heads; when only d_inner is cut, x is all-gathered
and the scan runs on every head, and the rank keeps its d_inner block of
y. The gated norm's mean square over all of d_inner is all-reduced before
its rsqrt, and so are ``out_proj``'s partial sums. Under autograd (the
training layout) the mixer's input and the weights every rank holds
whole enter that cut work through ``grad_sum``, x's gather is a
``gather_part`` and the mean square's sum is summed back in the
backward pass too, so each rank's gradient of each of its shards is
that block of the one-device gradient.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models.common import normal_init, scaled_init
from repro_torch.sharding.local import (gather_part, grad_sum, reduce_sum,
                                        shard_block)


def init_ssm(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    s = cfg.ssm
    d, din, nh, ds, cw = (cfg.d_model, cfg.d_inner, cfg.n_ssm_heads,
                          s.d_state, s.conv_width)
    # dt bias initialised so softplus(dt_bias) spans [dt_min, dt_max]; drawn
    # from numpy's RandomState(0) exactly as the JAX package draws it
    u = np.random.RandomState(0).uniform(size=(nh,))
    dt_init = s.dt_min * (s.dt_max / s.dt_min) ** u
    dt_bias = np.log(np.expm1(dt_init))

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return {
        "wz": scaled_init(gen, (d, din), d, dtype, device),
        "wx": scaled_init(gen, (d, din), d, dtype, device),
        "wB": scaled_init(gen, (d, ds), d, dtype, device),
        "wC": scaled_init(gen, (d, ds), d, dtype, device),
        "wdt": scaled_init(gen, (d, nh), d, dtype, device),
        "conv_x": normal_init(gen, (cw, din), 0.2, dtype, device),
        "conv_B": normal_init(gen, (cw, ds), 0.2, dtype, device),
        "conv_C": normal_init(gen, (cw, ds), 0.2, dtype, device),
        "conv_bias_x": torch.zeros((din,), dtype=dtype, device=device),
        "conv_bias_B": torch.zeros((ds,), dtype=dtype, device=device),
        "conv_bias_C": torch.zeros((ds,), dtype=dtype, device=device),
        "A_log": f32(np.log(np.arange(1, nh + 1, dtype=np.float32))),
        "D": f32(np.ones((nh,), np.float32)),
        "dt_bias": f32(dt_bias),
        "norm_scale": torch.ones((din,), dtype=dtype, device=device),
        "out_proj": scaled_init(gen, (din, d), din, dtype, device),
    }


def _causal_conv(x, w, b, tail=None, valid=None):
    """Depthwise causal conv. x (B,S,C), w (cw,C), b (C,).

    ``tail`` (B,cw-1,C): the previous segment's last inputs (decode or an
    injected continuation); zeros if None. Returns (y (B,S,C), new_tail
    (B,cw-1,C)).

    ``valid`` (B,S) bool, a contiguous run per row (right-aligned prefill
    or left-aligned inject suffix): the new tail is gathered per row so it
    ends at the row's LAST REAL token; a row with no valid token passes
    the incoming tail through unchanged.
    """
    bsz, s, c = x.shape
    cw = w.shape[0]
    if tail is None:
        tail = torch.zeros((bsz, cw - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)                    # (B, S+cw-1, C)
    y = sum(xp[:, i:i + s] * w[i] for i in range(cw)) + b
    if valid is None:
        new_tail = xp[:, s:s + cw - 1]
    else:
        idx = torch.arange(s, device=x.device)[None, :]
        last = torch.where(valid, idx, -1).max(dim=-1).values
        rows = last[:, None] + 1 + torch.arange(cw - 1, device=x.device)
        new_tail = torch.take_along_dim(xp, rows[:, :, None], dim=1)
    return F.silu(y.float()).to(x.dtype), new_tail


def ssd_decode_step(x, dt, A, B, C, D, state, *, inplace: bool = False):
    """Single-token state update. x (b,nh,hp); dt (b,nh); B,C (b,ds);
    state (b,nh,hp,ds). Returns (y (b,nh,hp), new_state); with ``inplace``
    the new state is written into ``state`` and is that tensor."""
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    a = torch.exp(dtf * A[None, :])                     # (b,nh)
    if inplace:  # no (b,nh,hp,ds) temporaries
        new_state = state.mul_(a[:, :, None, None]).addcmul_(
            (dtf[:, :, None] * xf)[..., None], Bf[:, None, None, :])
    else:
        upd = torch.einsum("bh,bhp,bs->bhps", dtf, xf, Bf)
        new_state = a[:, :, None, None] * state + upd
    y = torch.einsum("bs,bhps->bhp", Cf, new_state) + D[None, :, None] * xf
    return y.to(x.dtype), new_state


def _gated_norm(y, z, scale, eps, mesh=None, d_inner=None):
    """Mamba2 gated RMSNorm: rmsnorm(y * silu(z)) * scale, in f32. On a
    mesh, with y and z the rank's block of ``d_inner`` channels, the sum
    of squares is all-reduced over the model axis."""
    g = y.float() * F.silu(z.float())
    if mesh is not None and g.shape[-1] != d_inner:
        # each rank uses the sum with its own block: its gradient is summed
        var = grad_sum(reduce_sum((g * g).sum(-1, keepdim=True), mesh),
                       mesh) / d_inner
    else:
        var = (g * g).mean(-1, keepdim=True)
    return g * torch.rsqrt(var + eps) * scale.float()


def _heads_of(params, cfg: ModelConfig, xr, mesh):
    """(x for the scan, its heads, a function from the scan's y to the
    rank's d_inner block). Without a cut, or when the rank's heads line
    up with its d_inner block, x is the rank's own; when only d_inner is
    cut, x is all-gathered to every head and y is cut back."""
    din_local = params["wz"].shape[-1]
    nh_local = params["wdt"].shape[-1]
    if din_local == nh_local * cfg.ssm.head_dim:
        return xr, nh_local, lambda y: y
    blk = shard_block(cfg.d_inner, "model", mesh)
    return (gather_part(xr, mesh, "model", -1), cfg.n_ssm_heads,
            lambda y: y[..., blk])


def _out(params, y, cfg: ModelConfig, mesh):
    """``out_proj`` of the gated output, its partial sums all-reduced
    when the rank holds a d_inner block of its rows."""
    out = y @ params["out_proj"]
    if params["out_proj"].shape[0] != cfg.d_inner:
        out = reduce_sum(out, mesh)
    return out


# the leaves every rank holds whole (the shared B/C path), and those it
# holds whole when the heads do not divide the model axis
_SHARED = ("wB", "wC", "conv_B", "conv_C", "conv_bias_B", "conv_bias_C")
_HEADS = ("wdt", "A_log", "D", "dt_bias")


def _enter(params, x, cfg: ModelConfig, mesh):
    """The mixer's input and params as a cut mixer (``out_proj`` a block
    of d_inner rows) uses them: ``x`` and the leaves every rank holds
    whole enter through ``grad_sum``."""
    if mesh is None or params["out_proj"].shape[0] == cfg.d_inner:
        return params, x
    params = dict(params)
    whole = _SHARED + (_HEADS if params["wdt"].shape[-1] == cfg.n_ssm_heads
                       else ())
    for name in whole:
        params[name] = grad_sum(params[name], mesh)
    return params, grad_sum(x, mesh)


def _project(params, x):
    """The five input projections of x (B,S,d) or (B,d)."""
    return tuple(x @ params[k] for k in ("wz", "wx", "wB", "wC", "wdt"))


def ssm_forward(params, x, cfg: ModelConfig, *, cache=None, valid=None,
                use_kernel: bool = True, mesh=None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence Mamba2 mixer. x (B,S,d) -> (y (B,S,d), cache).

    cache = {"conv_x", "conv_B", "conv_C" tails, "state"}, returned so a
    decode session (or an injected suffix) can resume from it; given one,
    the sequence continues it.

    ``valid`` (B,S) bool: padding positions become identity steps of the
    recurrence (dt forced to 0: no decay, no state update), so left-padded
    batches do not contaminate the state. Pad-position outputs are garbage
    and must be masked by the caller.

    ``use_kernel=False`` runs the plain ``ssd_chunked`` on any device (the
    training path: the kernel has no backward).

    ``mesh``: the params and ``cache`` are the rank's shards (module
    docstring), and so is the returned cache.
    """
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    hp = s_cfg.head_dim

    params, x = _enter(params, x, cfg, mesh)
    z, xr, Br, Cr, dt = _project(params, x)
    if valid is not None:
        # zero pad inputs so they can't leak through the causal conv window
        vm = valid[..., None].to(xr.dtype)
        xr, Br, Cr = xr * vm, Br * vm, Cr * vm

    tails = cache or {}
    xr, tail_x = _causal_conv(xr, params["conv_x"], params["conv_bias_x"],
                              tails.get("conv_x"), valid)
    Br, tail_B = _causal_conv(Br, params["conv_B"], params["conv_bias_B"],
                              tails.get("conv_B"), valid)
    Cr, tail_C = _causal_conv(Cr, params["conv_C"], params["conv_bias_C"],
                              tails.get("conv_C"), valid)

    dt = F.softplus(dt.float() + params["dt_bias"])
    if valid is not None:
        dt = dt * valid[..., None].float()               # identity steps
    A = -torch.exp(params["A_log"])
    xr, nh, own = _heads_of(params, cfg, xr, mesh)
    scan = ssd_scan if use_kernel else ssd_chunked
    y, h_final = scan(xr.reshape(b, s, nh, hp).contiguous(),
                      dt.contiguous(), A.contiguous(), Br.contiguous(),
                      Cr.contiguous(), params["D"].contiguous(),
                      chunk=min(s_cfg.chunk_size, s),
                      init_state=tails.get("state"))

    y = _gated_norm(own(y.reshape(b, s, -1)), z, params["norm_scale"],
                    cfg.norm_eps, mesh, cfg.d_inner).to(x.dtype)
    return _out(params, y, cfg, mesh), {"conv_x": tail_x, "conv_B": tail_B,
                                        "conv_C": tail_C, "state": h_final}


def ssm_decode(params, x, cache, cfg: ModelConfig, *, inplace: bool = False,
               mesh=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode. x (B,1,d); cache from ``ssm_forward`` or
    ``init_ssm_cache``. The caller's cache is left as it was unless
    ``inplace``, which writes the new tails and state into its tensors
    and returns them. ``mesh``: the params and the cache are the rank's
    shards."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    hp = s_cfg.head_dim
    z, xr, Br, Cr, dt = _project(params, x[:, 0])

    def conv_step(tail, new, w, bias):
        # tail (B,cw-1,C), new (B,C)
        window = torch.cat([tail, new[:, None]], dim=1)  # (B,cw,C)
        y = torch.einsum("bwc,wc->bc", window, w) + bias
        return F.silu(y.float()).to(new.dtype), window[:, 1:]

    xr, tail_x = conv_step(cache["conv_x"], xr, params["conv_x"],
                           params["conv_bias_x"])
    Br, tail_B = conv_step(cache["conv_B"], Br, params["conv_B"],
                           params["conv_bias_B"])
    Cr, tail_C = conv_step(cache["conv_C"], Cr, params["conv_C"],
                           params["conv_bias_C"])

    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xr, nh, own = _heads_of(params, cfg, xr, mesh)
    y, new_state = ssd_decode_step(xr.reshape(b, nh, hp), dt, A, Br, Cr,
                                   params["D"], cache["state"],
                                   inplace=inplace)

    y = _gated_norm(own(y.reshape(b, -1)), z, params["norm_scale"],
                    cfg.norm_eps, mesh, cfg.d_inner).to(x.dtype)
    out = _out(params, y, cfg, mesh)[:, None, :]
    tails = {"conv_x": tail_x, "conv_B": tail_B, "conv_C": tail_C}
    if inplace:
        for name, t in tails.items():
            tails[name] = cache[name].copy_(t)
    return out, dict(tails, state=new_state)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device="cuda") -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    tail = s.conv_width - 1
    return {
        "conv_x": torch.zeros((batch, tail, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, tail, s.d_state), dtype=dtype,
                              device=device),
        "conv_C": torch.zeros((batch, tail, s.d_state), dtype=dtype,
                              device=device),
        "state": torch.zeros((batch, cfg.n_ssm_heads, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }
