"""The port's MoE layer (``repro_torch.models.moe``) and the MoE stacks
against the JAX package's, on the CPU at fp32 with TF32 off.

The same weights (JAX ``init_params``, carried over with
``weights.params_from_numpy``) and the same numpy inputs go through both
packages. ``moe_apply`` must agree within 1e-5 on ``y`` and 1e-6 on the
aux loss on random rows, rows built to overflow an expert's capacity (so
tokens are dropped), exact ties in the router probabilities (the lower
expert wins, and the stable dispatch order decides the drops), one token
a row, and the drop-free capacity of ``no_drop()``. The reduced
granite, mixtral and jamba stacks must agree through ``forward``,
``prefill``, ``extend`` and ``decode_step`` within 1e-5, and one train
step each (``make_train_step``) on its loss and summed ``moe_aux``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import moe as jax_moe
from repro.models import model as jax_model
from repro.models.model import init_params as jax_init_params
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_train
from repro_torch.models import moe
from repro_torch.models.model import (_forward, cache_from_prefill,
                                      decode_step, extend, prefill)
from repro_torch.training import optimizer, train_loop
from repro_torch.weights import params_from_numpy
from torch_port import port_cfg

TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)
MOE_ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b", "jamba-v0.1-52b")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _granite_layer():
    jcfg = jax_reduced(jax_get_config("granite-moe-3b-a800m"), d_model=64)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, {k: np.asarray(v[0])
                  for k, v in jp["blocks"]["pos0"]["moe"].items()}


def _layer():
    """One MoE layer's weights (granite reduced to 4 experts, top-2), as
    writable copies."""
    jcfg, leaves = _granite_layer()
    return jcfg, {k: v.copy() for k, v in leaves.items()}


def _dropped(jcfg, x, leaves):
    """How many (token, expert) pairs the reference drops on ``x``."""
    logits = np.einsum("bsd,de->bse", x, leaves["router"])
    top = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)),
                                   jcfg.moe.top_k)[1])
    c = jax_moe.moe_capacity(x.shape[1], jcfg)
    counts = [np.bincount(row.ravel(), minlength=jcfg.moe.n_experts)
              for row in top]
    return int(sum(np.maximum(cnt - c, 0).sum() for cnt in counts))


def _case(name):
    """(jcfg, leaves, x) for one ``moe_apply`` case."""
    jcfg, leaves = _layer()
    rng = np.random.RandomState(3)
    d = jcfg.d_model
    if name == "random":
        x = rng.randn(3, 24, d)
    elif name == "overflow":
        # every token prefers experts 0 and 1: 24 tokens x 2 picks
        # against a capacity of 15 each
        leaves["router"] = rng.randn(d, 4).astype(np.float32) * 0.01
        leaves["router"][:, :2] += 0.5
        x = np.abs(rng.randn(2, 24, d))
    elif name == "ties":
        # experts 1 and 2 have the same router column, expert 3 a zero
        # one; rows 0 and 1 are all-zero tokens (four-way exact ties)
        leaves["router"][:, 2] = leaves["router"][:, 1]
        leaves["router"][:, 3] = 0.0
        x = rng.randn(3, 16, d)
        x[:2, :5] = 0.0
    elif name == "one_token":
        x = rng.randn(5, 1, d)
    else:  # no_drop: the overflow rows at the drop-free capacity
        jcfg = dataclasses.replace(jcfg, moe=jcfg.moe.no_drop())
        leaves["router"][:, :2] += 0.5
        x = np.abs(rng.randn(2, 24, d))
    return jcfg, leaves, x.astype(np.float32)


@pytest.mark.parametrize("name", ["random", "overflow", "ties", "one_token",
                                  "no_drop"])
def test_moe_apply_matches_jax(name):
    jcfg, leaves, x = _case(name)
    drops = _dropped(jcfg, x, leaves)
    assert (drops > 0) == (name in ("overflow", "ties")), drops
    jy, jaux = jax.jit(jax_moe.moe_apply, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in leaves.items()}, jnp.asarray(x), jcfg)
    y, aux = moe.moe_apply({k: _t(v) for k, v in leaves.items()}, _t(x),
                           port_cfg(jcfg))
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **AUX_TOL)
    assert moe.moe_capacity(x.shape[1], port_cfg(jcfg)) == \
        jax_moe.moe_capacity(x.shape[1], jcfg)


def test_init_moe_follows_the_jax_tree():
    jcfg, leaves = _layer()
    got = moe.init_moe(torch.Generator().manual_seed(0), port_cfg(jcfg),
                       torch.bfloat16, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        "router": ((64, 4), torch.float32),
        "gate": ((4, 64, 128), torch.bfloat16),
        "up": ((4, 64, 128), torch.bfloat16),
        "down": ((4, 128, 64), torch.bfloat16)}
    assert {k: v.shape for k, v in leaves.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}


# ----------------------------------------------------------------------
# the reduced MoE stacks
# ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE_ARCHS)
def stack(request):
    jcfg = jax_reduced(jax_get_config(request.param), d_model=64)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = port_cfg(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _history(cfg, b=4, s=32, seed=0):
    """Right-aligned histories: row 1 left-padded, row 2 one token."""
    rng = np.random.RandomState(seed)
    valid = np.ones((b, s), bool)
    valid[1, :11] = False
    valid[2, :s - 1] = False
    tokens = np.where(valid, rng.randint(1, cfg.vocab_size, (b, s)), 0)
    return tokens.astype(np.int32), valid


def _suffix(cfg, b=4, ss=8, seed=1):
    """Left-aligned suffixes: full, partial, empty, one token."""
    rng = np.random.RandomState(seed)
    valid = np.zeros((b, ss), bool)
    valid[0] = True
    valid[1, :3] = True
    valid[3, :1] = True
    tokens = np.where(valid, rng.randint(1, cfg.vocab_size, (b, ss)), 0)
    return tokens.astype(np.int32), valid


# the JAX entry points jitted (one compile each instead of op by op)
jax_forward = jax.jit(jax_model.forward, static_argnums=1)
jax_prefill = jax.jit(jax_model.prefill, static_argnums=1)
jax_extend = jax.jit(jax_model.extend, static_argnums=1)
jax_decode_step = jax.jit(jax_model.decode_step, static_argnums=1)
jax_cache_from_prefill = jax.jit(jax_model.cache_from_prefill,
                                 static_argnums=(0, 2))


def _assert_tree(got, want):
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == set(want[key]), key
        for name, w in want[key].items():
            g, w = got[key][name].numpy(), np.asarray(w)
            if w.dtype == bool:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, **TOL)


def test_stack_matches_jax(stack):
    """forward (logits and the summed aux), prefill, extend, then
    cache_from_prefill and three decode steps."""
    jcfg, jparams, cfg, params = stack
    assert "moe" in cfg.mlp_kinds()
    tokens, valid = _history(cfg, seed=6)
    want, jaux = jax_forward(jparams, jcfg, jnp.asarray(tokens),
                             valid=jnp.asarray(valid))
    got, aux = _forward(params, cfg, _t(tokens), valid=_t(valid))
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **AUX_TOL)
    assert float(aux) > 0

    _, jpc = jax_prefill(jparams, jcfg, jnp.asarray(tokens),
                         valid=jnp.asarray(valid))
    got, pc = prefill(params, cfg, _t(tokens), valid=_t(valid))
    np.testing.assert_allclose(got.numpy()[:, -1],
                               np.asarray(want)[:, -1], **TOL)
    _assert_tree(pc, jpc)

    stoks, svalid = _suffix(cfg, seed=8)
    start = np.full(4, tokens.shape[1], np.int32)
    want, jec = jax_extend(jparams, jcfg, jpc, jnp.asarray(stoks),
                           jnp.asarray(start), valid=jnp.asarray(svalid),
                           prefix_valid=jnp.asarray(valid))
    got, ec = extend(params, cfg, pc, _t(stoks), _t(start), valid=_t(svalid),
                     prefix_valid=_t(valid))
    np.testing.assert_allclose(got.numpy()[svalid],
                               np.asarray(want)[svalid], **TOL)
    _assert_tree(ec, jec)

    full_valid = np.concatenate([valid, svalid], 1)
    jdc = jax_cache_from_prefill(jcfg, jec, 48, valid=jnp.asarray(full_valid))
    dc = cache_from_prefill(cfg, ec, 48, valid=_t(full_valid))
    pos = np.full(4, 40, np.int32)
    rng = np.random.RandomState(9)
    for _ in range(3):
        tok = rng.randint(1, cfg.vocab_size, (4, 1)).astype(np.int32)
        want, jdc = jax_decode_step(jparams, jcfg, jdc, jnp.asarray(tok),
                                    jnp.asarray(pos))
        got, dc = decode_step(params, cfg, dc, _t(tok), _t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_tree(dc, jdc)
        pos = pos + 1


def test_train_step_matches_jax(stack):
    """One ``make_train_step`` against the jitted JAX step: loss, moe_aux
    (in the loss), accuracy and grad norm, and the params after AdamW
    (eps 1e-3, as tests/test_torch_training.py says why)."""
    jcfg, jparams, cfg, params = stack
    rng = np.random.RandomState(2)
    toks = rng.randint(1, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    kw = dict(lr=3e-2, warmup_steps=2, total_steps=100, eps=1e-3)
    jstep = jax.jit(jax_train.make_train_step(jcfg, jax_train.TrainConfig(
        adamw=jax_opt.AdamWConfig(**kw), remat=True,
        param_dtype=jnp.float32)))
    tstep = train_loop.make_train_step(cfg, train_loop.TrainConfig(
        adamw=optimizer.AdamWConfig(**kw), remat=True,
        param_dtype=torch.float32))
    jp, _, jm = jstep(jparams, jax_opt.init_opt_state(jparams),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    tp, _, tm = tstep(params, optimizer.init_opt_state(params), batch)
    assert float(tm["moe_aux"]) > 0
    for name in ("loss", "acc", "grad_norm"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   **TOL)
    np.testing.assert_allclose(tm["moe_aux"].numpy(),
                               np.asarray(jm["moe_aux"]), **AUX_TOL)
    for key in ("router", "gate", "down"):
        for pos, blk in jp["blocks"].items():
            if "moe" in blk:
                np.testing.assert_allclose(
                    tp["blocks"][pos]["moe"][key].numpy(),
                    np.asarray(blk["moe"][key]), **TOL)
