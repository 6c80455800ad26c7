"""The port's KV-cache entry points against the JAX package's, on ``tiny-test``
(GQA, 4 query heads over 2 KV heads).

``prefill``, ``extend``, ``cache_from_prefill``, ``init_cache`` and
``decode_step`` get the same numpy inputs and the same weights (JAX
``init_params``, converted); caches are compared leaf by leaf in the JAX
tree ``{"pos{p}": {"k", "v"[, "valid"]}}``. Everything is fp32 with TF32
off. Tolerance 1e-5 absolute and relative for model math (XLA and torch
order their f32 sums differently); ``cache_from_prefill`` is pure data
movement and must be bit-equal on the same input.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_model_config
from torch_port import port_cfg
from repro.models.attention import attention_decode as jax_attention_decode
from repro.models.attention import attention_full as jax_attention_full
from repro.models.model import cache_from_prefill as jax_cache_from_prefill
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import extend as jax_extend
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import init_params as jax_init_params
from repro.models.model import prefill as jax_prefill
from repro_torch.models.attention import attention_decode, attention_full
from repro_torch.models.model import (Ranker, cache_from_prefill, decode_step,
                                      extend, init_cache, prefill)
from repro_torch.weights import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _models(window=0):
    jcfg = dataclasses.replace(tiny_model_config(), sliding_window=window)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = port_cfg(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def tiny():
    return _models()


@pytest.fixture(scope="module")
def tiny_swa():
    return _models(window=8)


def _history(cfg, b=4, s=20, seed=0):
    """Right-aligned histories: row 1 left-padded, row 2 a single token,
    the rest full."""
    rng = np.random.RandomState(seed)
    valid = np.ones((b, s), bool)
    valid[1, :7] = False
    valid[2, :s - 1] = False
    tokens = np.where(valid, rng.randint(1, cfg.vocab_size, (b, s)), 0)
    return tokens.astype(np.int32), valid


def _suffix(cfg, b=4, ss=6, seed=1):
    """Left-aligned suffixes: row 0 full, row 1 partial, row 2 empty."""
    rng = np.random.RandomState(seed)
    valid = np.ones((b, ss), bool)
    valid[1, 2:] = False
    valid[2] = False
    valid[3, 4:] = False
    tokens = np.where(valid, rng.randint(1, cfg.vocab_size, (b, ss)), 0)
    return tokens.astype(np.int32), valid


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_tree(got, want, exact=False):
    """Leaf by leaf over the JAX cache tree."""
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == set(want[key]), key
        for name, w in want[key].items():
            g = got[key][name].numpy()
            assert g.shape == w.shape, (key, name)
            if exact or w.dtype == bool:
                np.testing.assert_array_equal(g, np.asarray(w))
            else:
                np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_logits_and_kv_match_jax(tiny, last_only):
    jcfg, jparams, cfg, params = tiny
    tokens, valid = _history(cfg)
    want, jcaches = jax_prefill(jparams, jcfg, jnp.asarray(tokens),
                                valid=jnp.asarray(valid),
                                logits_last_only=last_only)
    got, caches = prefill(params, cfg, _t(tokens), valid=_t(valid),
                          logits_last_only=last_only)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_tree(caches, jcaches)
    assert caches["pos0"]["k"].shape == (2, 4, 20, 2, 16)  # (R, B, S, nkv, hd)


def test_extend_logits_and_caches_match_jax(tiny):
    """The injection: a left-aligned suffix against a right-aligned
    prefill, empty and partial suffix rows included."""
    jcfg, jparams, cfg, params = tiny
    tokens, valid = _history(cfg)
    stoks, svalid = _suffix(cfg)
    start = np.full(4, tokens.shape[1], np.int32)
    _, jpc = jax_prefill(jparams, jcfg, jnp.asarray(tokens),
                         valid=jnp.asarray(valid))
    want, jcaches = jax_extend(jparams, jcfg, jpc, jnp.asarray(stoks),
                               jnp.asarray(start), valid=jnp.asarray(svalid),
                               prefix_valid=jnp.asarray(valid))
    _, pc = prefill(params, cfg, _t(tokens), valid=_t(valid))
    got, caches = extend(params, cfg, pc, _t(stoks), _t(start),
                         valid=_t(svalid), prefix_valid=_t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_tree(caches, jcaches)
    assert caches["pos0"]["k"].shape[2] == 26  # prefix + suffix


def test_attention_full_prefix_positions_match_jax(tiny):
    """Explicit prefix positions and validity (the engine passes neither
    positions: it relies on the slot-index default, tested above)."""
    jcfg, jparams, cfg, params = tiny
    rng = np.random.RandomState(3)
    b, sp, s = 3, 10, 5
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pk = rng.normal(size=(b, sp, 2, 16)).astype(np.float32)
    pv = rng.normal(size=(b, sp, 2, 16)).astype(np.float32)
    ppos = np.tile(np.arange(3, 3 + sp, dtype=np.int32), (b, 1))
    pval = rng.rand(b, sp) < 0.7
    qpos = np.tile(np.arange(sp + 3, sp + 3 + s, dtype=np.int32), (b, 1))
    lp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["attn"])
    jy, jkv = jax_attention_full(
        lp, jnp.asarray(x), jnp.asarray(qpos), jcfg,
        prefix_kv={"k": jnp.asarray(pk), "v": jnp.asarray(pv)},
        prefix_positions=jnp.asarray(ppos), prefix_valid=jnp.asarray(pval))
    tp = {k: v[0] for k, v in params["blocks"]["pos0"]["attn"].items()}
    y, kv = attention_full(tp, _t(x), _t(qpos), cfg,
                           prefix_kv={"k": _t(pk), "v": _t(pv)},
                           prefix_positions=_t(ppos), prefix_valid=_t(pval))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(kv[name].numpy(), np.asarray(jkv[name]),
                                   **TOL)


@pytest.mark.parametrize("capacity,with_valid", [
    (32, True),    # pad branch, rows compacted
    (20, True),    # exactly full: the ring branch with shift 0
    (16, True),    # ring-roll branch, capacity below the sequence length
    (7, True),     # ring-roll with a shift of 6
    (32, False),   # no pad mask
    (16, False),
])
def test_cache_from_prefill_bit_equal(tiny, capacity, with_valid):
    """Same prefill K/V into both functions: stable compaction of each
    row, then the roll or the padding, bit for bit."""
    jcfg, jparams, cfg, _ = tiny
    tokens, valid = _history(cfg)
    valid[3, [0, 5, 6, 11]] = False      # holes, not only a left pad
    _, jpc = jax_prefill(jparams, jcfg, jnp.asarray(tokens),
                         valid=jnp.asarray(valid))
    vmask = valid if with_valid else None
    want = jax_cache_from_prefill(
        jcfg, jpc, capacity,
        valid=None if vmask is None else jnp.asarray(vmask))
    pc = {k: {n: _t(a) for n, a in v.items()} for k, v in jpc.items()}
    got = cache_from_prefill(cfg, pc, capacity,
                             valid=None if vmask is None else _t(vmask))
    _assert_tree(got, want, exact=True)


def test_init_cache_matches_jax(tiny_swa):
    jcfg, _, cfg, _ = tiny_swa
    want = jax_init_cache(jcfg, 3, 64, dtype=jnp.float32)
    got = init_cache(cfg, 3, 64, torch.float32, "cpu")
    _assert_tree(got, want, exact=True)
    assert got["pos0"]["k"].shape[2] == 8  # clamped to the window


def _decode_run(models, s, capacity, n_steps, seed):
    jcfg, jparams, cfg, params = models
    tokens, valid = _history(cfg, s=s, seed=seed)
    nxt = np.random.RandomState(seed + 1).randint(
        1, cfg.vocab_size, (4, n_steps)).astype(np.int32)
    _, jpc = jax_prefill(jparams, jcfg, jnp.asarray(tokens),
                         valid=jnp.asarray(valid))
    jdc = jax_cache_from_prefill(jcfg, jpc, capacity,
                                 valid=jnp.asarray(valid))
    _, pc = prefill(params, cfg, _t(tokens), valid=_t(valid))
    dc = cache_from_prefill(cfg, pc, capacity, valid=_t(valid))
    for i in range(n_steps):
        pos = np.full(4, s + i, np.int32)
        want, jdc = jax_decode_step(jparams, jcfg, jdc,
                                    jnp.asarray(nxt[:, i:i + 1]),
                                    jnp.asarray(pos))
        got, dc = decode_step(params, cfg, dc, _t(nxt[:, i:i + 1]), _t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_tree(dc, jdc)


@pytest.mark.parametrize("s,capacity", [
    (20, 64),   # the ring never fills
    (20, 22),   # fills and wraps during the steps
    (20, 16),   # starts from a rolled ring
])
def test_decode_steps_match_jax(tiny, s, capacity):
    """prefill -> cache_from_prefill -> 5 decode steps, a left-padded row
    and a one-token row included; logits and the whole ring at each step."""
    _decode_run(tiny, s, capacity, n_steps=5, seed=4)


def test_decode_steps_sliding_window_match_jax(tiny_swa):
    """A window of 8: the ring is clamped to 8 slots and wraps every step."""
    _decode_run(tiny_swa, 20, 1024, n_steps=4, seed=5)


def test_attention_decode_with_unstored_slots_matches_jax(tiny):
    """The layer's masked contraction with ``stored`` False on some slots
    (left-padded prefills), on partial, full and wrapped rings."""
    jcfg, jparams, cfg, params = tiny
    rng = np.random.RandomState(6)
    b, w = 4, 12
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    k = rng.normal(size=(b, w, 2, 16)).astype(np.float32)
    v = rng.normal(size=(b, w, 2, 16)).astype(np.float32)
    stored = rng.rand(b, w) < 0.6
    pos = np.array([3, 11, 12, 30], np.int32)
    lp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["attn"])
    jy, jc = jax_attention_decode(
        lp, jnp.asarray(x), jnp.asarray(pos),
        {"k": jnp.asarray(k), "v": jnp.asarray(v),
         "valid": jnp.asarray(stored)}, jcfg)
    tp = {n: a[0] for n, a in params["blocks"]["pos0"]["attn"].items()}
    y, c = attention_decode(tp, _t(x), _t(pos),
                            {"k": _t(k), "v": _t(v), "valid": _t(stored)},
                            cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _assert_tree({"l": c}, {"l": jc})


def test_decode_step_leaves_the_callers_cache(tiny):
    """decode_step returns a new cache, as the JAX one does; ``inplace``
    writes into the given one and returns the same values."""
    _, _, cfg, params = tiny
    tokens, valid = _history(cfg)
    _, pc = prefill(params, cfg, _t(tokens), valid=_t(valid))
    dc = cache_from_prefill(cfg, pc, 32, valid=_t(valid))
    before = {k: {n: t.clone() for n, t in v.items()} for k, v in dc.items()}
    tok = torch.full((4, 1), 7, dtype=torch.int32)
    pos = torch.full((4,), 20, dtype=torch.int32)
    logits, new = decode_step(params, cfg, dc, tok, pos)
    for key in dc:
        for name in dc[key]:
            assert torch.equal(dc[key][name], before[key][name])
    logits2, same = decode_step(params, cfg, dc, tok, pos, inplace=True)
    assert same is dc
    assert torch.equal(logits2, logits)
    for key in dc:
        for name in dc[key]:
            assert torch.equal(dc[key][name], new[key][name])


def test_ranker_cache_methods(tiny):
    """``Ranker``'s methods are the functions over its own params."""
    _, _, cfg, params = tiny
    ranker = Ranker(cfg, params)
    tokens, valid = _history(cfg)
    stoks, svalid = _suffix(cfg)
    want, pc = prefill(params, cfg, _t(tokens), valid=_t(valid))
    got, rpc = ranker.prefill(_t(tokens), valid=_t(valid))
    assert torch.equal(got, want)
    start = torch.full((4,), 20, dtype=torch.int32)
    want, ec = extend(params, cfg, pc, _t(stoks), start, valid=_t(svalid),
                      prefix_valid=_t(valid))
    got, rec = ranker.extend(rpc, _t(stoks), start, valid=_t(svalid),
                             prefix_valid=_t(valid))
    assert torch.equal(got, want)
    full_valid = torch.cat([_t(valid), _t(svalid)], 1)
    dc = ranker.cache_from_prefill(rec, 40, valid=full_valid)
    tok = torch.ones((4, 1), dtype=torch.int32)
    got, _ = ranker.decode_step(dc, tok, start + 6)
    want, _ = decode_step(params, cfg,
                          cache_from_prefill(cfg, ec, 40, valid=full_valid),
                          tok, start + 6)
    assert torch.equal(got, want)
    empty = ranker.init_cache(4, 16)
    assert empty["pos0"]["k"].shape == (2, 4, 16, 2, 16)
    assert empty["pos0"]["valid"].all()
