"""The port's ``ServingEngine`` against the JAX package's, on ``tiny-test``.

Both engines run ``max_batch=4``, ``prefill_len=32``, ``inject_len=8`` and
a 64-slot ring (the shared ``conftest.tiny_engine``), with the same
weights (JAX ``init_params``, converted) and the same numpy inputs, fp32
with TF32 off. ``pad_tokens`` must be bit-equal; logits within 1e-5
absolute and relative (XLA and torch order their f32 sums differently);
greedy slates equal, ``row_lens`` tails included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_engine
from repro_torch.configs import ModelConfig
from repro_torch.serving import ServingConfig, ServingEngine
from repro_torch.weights import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HISTS = [[5, 7, 9, 11, 13, 2, 4, 6], list(range(100, 140)), [300], []]
FRESH = [[21, 22, 23], [30], [], [40, 41, 42, 43, 44, 45, 46, 47, 48]]
FRESH2 = [[50], [51, 52], [53, 54, 55], []]


@pytest.fixture(scope="module")
def engines():
    jeng = tiny_engine()
    s = jeng.scfg
    cfg = ModelConfig(**{f: getattr(jeng.cfg, f) for f in
                         ModelConfig.__dataclass_fields__})
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), cfg,
                               device="cpu")
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=s.max_batch, prefill_len=s.prefill_len,
        inject_len=s.inject_len, cache_capacity=s.cache_capacity),
        device="cpu")
    return jeng, eng


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **TOL)


def _states(engines, hists=HISTS, fresh=FRESH, fallback=True):
    """prefill -> inject on both engines."""
    jeng, eng = engines
    out = []
    for e in (jeng, eng):
        toks, valid = e.pad_tokens(hists, e.scfg.prefill_len)
        st = e.prefill(toks, valid)
        stoks, svalid = e.pad_tokens(fresh, e.scfg.inject_len, align="left")
        fb = st["logits"][:, -1] if fallback else None
        out.append((st, e.inject(st, stoks, svalid, fallback_logits=fb)))
    return out


@pytest.mark.parametrize("seqs,length,align", [
    (HISTS, 32, "right"),
    (FRESH, 8, "left"),
    ([list(range(1, 13))], 8, "right"),      # truncation keeps the tail
    ([list(range(1, 13)), []], 8, "left"),
    ([], 5, "right"),
])
def test_pad_tokens_bit_equal(engines, seqs, length, align):
    jeng, eng = engines
    want = jeng.pad_tokens(seqs, length, align=align)
    got = eng.pad_tokens(seqs, length, align=align)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="max_batch"):
        eng.pad_tokens([[1]] * 5, 8)


def test_prefill_and_inject_match_jax(engines):
    """An empty history row and an empty suffix row included; the empty
    suffix row's ``first_logits`` is its fallback."""
    (jpre, jst), (pre, st) = _states(engines)
    _close(pre["logits"], jpre["logits"])
    np.testing.assert_array_equal(_np(pre["next_pos"]), np.asarray(
        jpre["next_pos"]))
    for key in ("next_pos", "n_valid", "valid"):
        assert _np(st[key]).dtype == np.asarray(jst[key]).dtype
        np.testing.assert_array_equal(_np(st[key]), np.asarray(jst[key]))
    for key in ("logits", "last_valid_logits", "first_logits"):
        _close(st[key], jst[key])
    for name in ("k", "v"):
        _close(st["caches"]["pos0"][name], jst["caches"]["pos0"][name])
    assert int(st["n_valid"][2]) == 0
    assert torch.equal(st["first_logits"][2], pre["logits"][2, -1])


def test_inject_without_fallback(engines):
    (_, jst), (_, st) = _states(engines, fallback=False)
    assert "first_logits" not in st and "first_logits" not in jst
    _close(st["last_valid_logits"], jst["last_valid_logits"])


def test_decode_matches_jax_and_leaves_the_callers_cache(engines):
    jeng, eng = engines
    (_, jst), (_, st) = _states(engines)
    jdec, dec = jeng.finalize(jst), eng.finalize(st)
    for name in ("k", "v", "valid"):
        want = jdec["caches"]["pos0"][name]
        got = dec["caches"]["pos0"][name]
        if name == "valid":
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        else:
            _close(got, want)
    dec0 = dec
    before = {n: t.clone() for n, t in dec0["caches"]["pos0"].items()}
    pos_before = dec0["pos"].clone()
    tok = np.array([[50], [60], [70], [80]], np.int32)
    for _ in range(3):
        jlog, jdec = jeng.decode(jdec, tok)
        log, dec = eng.decode(dec, tok)
        _close(log, jlog)
        np.testing.assert_array_equal(_np(dec["pos"]), np.asarray(jdec["pos"]))
        tok = np.asarray(jeng.sample(jlog))[:, None]
        np.testing.assert_array_equal(_np(eng.sample(log))[:, None], tok)
    for n, t in dec0["caches"]["pos0"].items():
        assert torch.equal(t, before[n])
    assert torch.equal(dec0["pos"], pos_before)


@pytest.mark.parametrize("row_lens", [None, [5, 1, 3, 0]])
def test_decode_slate_matches_jax(engines, row_lens):
    jeng, eng = engines
    (_, jst), (_, st) = _states(engines)
    lens = None if row_lens is None else np.array(row_lens, np.int32)
    want = jeng.decode_slate(jst, jst["first_logits"], 5, row_lens=lens)
    got = eng.decode_slate(st, st["first_logits"], 5, row_lens=lens)
    assert got.dtype == np.int32 and got.shape == (4, 5)
    np.testing.assert_array_equal(got, want)
    if row_lens is not None:
        assert (got[1, 1:] == -1).all() and (got[3] == -1).all()
    for row in got:
        items = row[row >= 0]
        assert len(set(items.tolist())) == len(items)


def test_double_injection_matches_jax(engines):
    """Two injection rounds: the first suffix's pad slots sit at slot
    indices at or past the second suffix's query positions and are
    masked by ``prefix_valid``."""
    jeng, eng = engines
    states = []
    for e in (jeng, eng):
        toks, valid = e.pad_tokens(HISTS, 32)
        st = e.prefill(toks, valid)
        for f in (FRESH, FRESH2):
            stoks, svalid = e.pad_tokens(f, 8, align="left")
            st = e.inject(st, stoks, svalid,
                          fallback_logits=st["logits"][:, -1])
        states.append(st)
    jst, st = states
    np.testing.assert_array_equal(_np(st["next_pos"]),
                                  np.asarray(jst["next_pos"]))
    _close(st["first_logits"], jst["first_logits"])
    want = jeng.decode_slate(jst, jst["first_logits"], 4)
    got = eng.decode_slate(st, st["first_logits"], 4)
    np.testing.assert_array_equal(got, want)


def test_forced_argmax_tie_picks_the_first(engines):
    """First logits with exact ties at the top: both engines pick the
    lower token id, then continue identically."""
    jeng, eng = engines
    (_, jst), (_, st) = _states(engines)
    vp = jst["first_logits"].shape[1]
    first = np.zeros((4, vp), np.float32)
    first[:, [17, 9, 200]] = 3.0          # a three-way tie
    first[1] = 0.0                        # a row that is all ties
    first[2] = 0.0
    first[2, [5, 4]] = 1.0                # a two-way tie
    want = jeng.decode_slate(jst, jnp.asarray(first), 4)
    got = eng.decode_slate(st, torch.from_numpy(first), 4)
    np.testing.assert_array_equal(got, want)
    assert list(got[:3, 0]) == [9, 0, 4]


def test_engine_is_greedy_only(engines):
    _, eng = engines
    hot = ServingEngine(eng.cfg, eng.params,
                        ServingConfig(max_batch=4, prefill_len=32,
                                      inject_len=8, cache_capacity=64,
                                      temperature=0.7), device="cpu")
    with pytest.raises(NotImplementedError):
        hot.decode_slate({}, torch.zeros((4, 8)), 3)
    with pytest.raises(NotImplementedError):
        hot._decode_slate_loop({}, torch.zeros((4, 8)), 3)
    # sampled decode is one token at a time, outside the slate
    logits = torch.zeros((4, 8))
    logits[:, 5] = 1.0
    assert hot.sample(logits, noise=torch.zeros((4, 8))).tolist() == [5] * 4


def test_decode_slate_loop_matches_jax_and_leaves_the_state(engines):
    """The eager loop (the CPU path of ``decode_slate`` and the card's
    reference for its graph) equals the JAX slate, twice over the same
    state: it advances a ring cache of its own, never ``state``'s."""
    jeng, eng = engines
    (_, jst), (_, st) = _states(engines)
    before = [t.clone() for t in st["caches"]["pos0"].values()]
    want = jeng.decode_slate(jst, jst["first_logits"], 6)
    for _ in range(2):
        got = eng._decode_slate_loop(st, st["first_logits"], 6)
        np.testing.assert_array_equal(got, want)
    for t, b in zip(st["caches"]["pos0"].values(), before):
        assert torch.equal(t, b)


@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_sample_matches_jax_categorical(engines, temperature):
    """``sample`` at ``temperature > 0`` against the JAX engine's
    (``jax.random.categorical``), given JAX's own gumbel draw for the same
    key as ``noise``: equal tokens. Without ``noise`` it draws from the
    engine's generator (or the one passed) in range."""
    from repro.serving.engine import ServingConfig as JaxServingConfig
    from repro.serving.engine import ServingEngine as JaxServingEngine

    jeng, eng = engines
    logits = np.random.RandomState(3).randn(4, eng.cfg.vocab_padded) \
        .astype(np.float32) * 3
    logits[:, eng.cfg.vocab_size:] = -1e30         # the padded vocab
    jhot = JaxServingEngine(jeng.cfg, jeng.params, JaxServingConfig(
        max_batch=4, prefill_len=32, inject_len=8, cache_capacity=64,
        temperature=temperature))
    hot = ServingEngine(eng.cfg, eng.params, ServingConfig(
        max_batch=4, prefill_len=32, inject_len=8, cache_capacity=64,
        temperature=temperature), device="cpu")
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jhot.sample(jnp.asarray(logits), key))
        noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
        got = hot.sample(torch.from_numpy(logits),
                         noise=torch.from_numpy(noise))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    draws = hot.sample(torch.from_numpy(logits),
                       generator=torch.Generator().manual_seed(1))
    assert ((draws >= 0) & (draws < eng.cfg.vocab_size)).all()
    assert torch.equal(hot.sample(torch.from_numpy(logits),
                                  generator=torch.Generator().manual_seed(1)),
                       draws)
