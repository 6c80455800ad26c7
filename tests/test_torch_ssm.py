"""The port's Mamba2 mixer and SSM stacks against the JAX package's.

Weights come from the JAX ``init_params`` and are converted with
``params_from_numpy``; inputs come from numpy seeds. The JAX side runs its
plain path (``use_kernel=False``: its kernel path cannot run on this host),
the port's CPU tensors run ``ssd_chunked``. Everything is fp32 with TF32
off. Tolerance 1e-5 absolute and relative: XLA and torch order their f32
sums differently. ``cache_from_prefill`` is data movement and must be
bit-equal on the same input.

Configs: ``reduced(mamba2-780m)`` (2 SSM layers, d 256, 16 heads of 32,
d_state 32, chunk 32) and a tiny mixed stack (``attn_period=2``, an
attention layer then an SSM layer, dense MLPs after both), which the JAX
``ModelConfig`` expresses as it is.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import ssm as jax_ssm
from repro.models.model import cache_from_prefill as jax_cache_from_prefill
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import extend as jax_extend
from repro.models.model import forward as jax_forward
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import init_params as jax_init_params
from repro.models.model import param_shapes as jax_param_shapes
from repro.models.model import prefill as jax_prefill
from repro_torch.configs import MoEConfig, get_config, reduced
from repro_torch.models import ssm
from repro_torch.models.model import (Ranker, cache_from_prefill, decode_step,
                                      extend, forward, init_cache,
                                      init_params, param_shapes, prefill)
from repro_torch.weights import params_from_numpy
from torch_port import port_cfg

TOL = dict(atol=1e-5, rtol=1e-5)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _models(jcfg):
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = port_cfg(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _mixed_config():
    """Two layers: attention at even layers, SSM at odd ones."""
    return dataclasses.replace(
        jax_reduced(jax_get_config("mamba2-780m"), n_layers=2, d_model=64),
        name="tiny-mixed", family="hybrid", n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, rope_theta=1e4,
        ssm=JaxSSMConfig(d_state=32, head_dim=32, chunk_size=8,
                         attn_period=2, attn_offset=0))


@pytest.fixture(scope="module")
def mamba():
    return _models(jax_reduced(jax_get_config("mamba2-780m")))


@pytest.fixture(scope="module")
def mixed():
    return _models(_mixed_config())


def _t(a):
    return torch.from_numpy(np.array(a))


def _history(cfg, b=4, s=32, seed=0):
    """Right-aligned histories: row 1 left-padded, row 2 a single token,
    row 3 all padding (a user with no history), row 0 full."""
    rng = np.random.RandomState(seed)
    valid = np.ones((b, s), bool)
    valid[1, :11] = False
    valid[2, :s - 1] = False
    valid[3] = False
    tokens = np.where(valid, rng.randint(1, cfg.vocab_size, (b, s)), 0)
    return tokens.astype(np.int32), valid


def _suffix(cfg, b=4, ss=8, seed=1):
    """Left-aligned suffixes: row 0 full, row 1 partial, row 2 empty, row 3
    a single token."""
    rng = np.random.RandomState(seed)
    valid = np.zeros((b, ss), bool)
    valid[0] = True
    valid[1, :3] = True
    valid[3, :1] = True
    tokens = np.where(valid, rng.randint(1, cfg.vocab_size, (b, ss)), 0)
    return tokens.astype(np.int32), valid


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


def _layer_params(jparams, params, key="pos0", r=0):
    jp = jax.tree.map(lambda a: a[r], jparams["blocks"][key]["ssm"])
    tp = {k: v[r] for k, v in params["blocks"][key]["ssm"].items()}
    return jp, tp


# ----------------------------------------------------------------------
# config, init and weights
# ----------------------------------------------------------------------

def test_mamba2_config_and_param_shapes_match_jax():
    """The registered mamba2-780m equals the JAX one field by field, and
    its param tree has the JAX tree's paths and shapes (no allocation)."""
    jcfg = jax_get_config("mamba2-780m")
    cfg = get_config("mamba2-780m")
    assert cfg == port_cfg(jcfg)
    assert (cfg.d_inner, cfg.n_ssm_heads) == (jcfg.d_inner, jcfg.n_ssm_heads)
    assert (cfg.d_inner, cfg.n_ssm_heads) == (3072, 48)
    assert reduced(cfg) == port_cfg(jax_reduced(jcfg))
    want = jax.tree.map(lambda x: tuple(x.shape), jax_param_shapes(jcfg))
    assert param_shapes(cfg) == want
    assert "mlp" not in want["blocks"]["pos0"]
    assert "norm2" not in want["blocks"]["pos0"]


def test_init_params_follow_the_jax_tree(mamba, mixed):
    """``init_params`` builds the JAX tree for SSM and mixed stacks: the
    same paths, shapes and leaf types in a bf16 model, and the dt bias
    drawn from numpy's RandomState(0) as the JAX package draws it."""
    for jcfg, _, cfg, _ in (mamba, mixed):
        jp = jax_init_params(jcfg, jax.random.PRNGKey(1))  # bf16
        tp = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.bfloat16, "cpu")
        flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
        for path, leaf in flat_j:
            t = tp
            for k in path:
                t = t[k.key]
            assert tuple(t.shape) == leaf.shape, path
            assert str(t.dtype).split(".")[1] == str(leaf.dtype), path
        for key, sub in jp["blocks"].items():
            if "ssm" in sub:
                for name in ("A_log", "D", "dt_bias"):
                    np.testing.assert_array_equal(
                        tp["blocks"][key]["ssm"][name].numpy(),
                        np.asarray(sub["ssm"][name]))


def test_params_from_numpy_keeps_f32_leaves(mamba):
    """A bf16 cast leaves the f32 leaves of the JAX tree (``A_log``, ``D``,
    ``dt_bias``) f32 and bit-equal; an f32 cast makes every leaf f32; no
    cast keeps each leaf's own type."""
    jcfg, _, cfg, _ = mamba
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(2)))
    for dtype in (None, torch.bfloat16):
        p = params_from_numpy(tree, cfg, device="cpu", dtype=dtype)["blocks"][
            "pos0"]["ssm"]
        for name in ("A_log", "D", "dt_bias"):
            assert p[name].dtype == torch.float32, (dtype, name)
            np.testing.assert_array_equal(
                p[name].numpy(), tree["blocks"]["pos0"]["ssm"][name])
        assert p["wx"].dtype == torch.bfloat16
    p = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    leaves = [p["embed"]["table"], *p["blocks"]["pos0"]["ssm"].values()]
    assert all(t.dtype == torch.float32 for t in leaves)


# ----------------------------------------------------------------------
# the mixer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("with_cache", [False, True])
def test_ssm_forward_matches_jax(mamba, with_cache):
    """The mixer over left-padded rows (a partly padded row and a row with
    no valid token), from scratch and continuing a cache: outputs at the
    valid positions, the conv tails gathered at each row's last real
    token (passed through for the empty row) and the final state."""
    jcfg, jparams, cfg, params = mamba
    jp, tp = _layer_params(jparams, params)
    rng = np.random.RandomState(3)
    b, s = 4, 32
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    _, valid = _history(cfg, b, s)
    cache = jcache = None
    if with_cache:
        din, ds = cfg.d_inner, cfg.ssm.d_state
        shapes = {"conv_x": (b, 3, din), "conv_B": (b, 3, ds),
                  "conv_C": (b, 3, ds),
                  "state": (b, cfg.n_ssm_heads, cfg.ssm.head_dim, ds)}
        np_cache = {k: rng.normal(size=v).astype(np.float32) * 0.5
                    for k, v in shapes.items()}
        cache = {k: _t(v) for k, v in np_cache.items()}
        jcache = {k: jnp.asarray(v) for k, v in np_cache.items()}
    jy, jc = jax_ssm.ssm_forward(jp, jnp.asarray(x), jcfg, cache=jcache,
                                 valid=jnp.asarray(valid))
    y, c = ssm.ssm_forward(tp, _t(x), cfg, cache=cache, valid=_t(valid))
    np.testing.assert_allclose(y.numpy()[valid], np.asarray(jy)[valid], **TOL)
    _assert_tree({"l": c}, {"l": jc})
    if with_cache:  # the all-padding row keeps its tails and its state
        for name in c:
            np.testing.assert_array_equal(c[name][3].numpy(),
                                          cache[name][3].numpy())


def test_causal_conv_tail_gather_matches_jax():
    """Tails end at each row's last real token, for right- and left-aligned
    runs, and a row with no valid token passes its tail through."""
    rng = np.random.RandomState(4)
    b, s, c, cw = 5, 10, 6, 4
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    w = rng.normal(size=(cw, c)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    tail = rng.normal(size=(b, cw - 1, c)).astype(np.float32)
    valid = np.zeros((b, s), bool)
    valid[0] = True
    valid[1, 4:] = True      # right-aligned
    valid[2, :2] = True      # left-aligned, shorter than the tail
    valid[3, :7] = True
    for t in (None, tail):
        jy, jt = jax_ssm._causal_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
            None if t is None else jnp.asarray(t), jnp.asarray(valid))
        y, nt = ssm._causal_conv(_t(x), _t(w), _t(bias),
                                 None if t is None else _t(t), _t(valid))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_array_equal(nt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(nt[4].numpy(), tail[4])


def test_ssm_decode_matches_jax(mamba):
    """Three one-token steps from a random cache, and the in-place form:
    the same values, written into the given tensors."""
    jcfg, jparams, cfg, params = mamba
    jp, tp = _layer_params(jparams, params)
    rng = np.random.RandomState(5)
    b = 3
    shapes = {"conv_x": (b, 3, cfg.d_inner), "conv_B": (b, 3, 32),
              "conv_C": (b, 3, 32), "state": (b, cfg.n_ssm_heads, 32, 32)}
    np_cache = {k: rng.normal(size=v).astype(np.float32) * 0.5
                for k, v in shapes.items()}
    jc = {k: jnp.asarray(v) for k, v in np_cache.items()}
    c = {k: _t(v) for k, v in np_cache.items()}
    own = {k: _t(v) for k, v in np_cache.items()}
    for step in range(3):
        x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jax_ssm.ssm_decode(jp, jnp.asarray(x), jc, jcfg)
        y, c = ssm.ssm_decode(tp, _t(x), c, cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        _assert_tree({"l": c}, {"l": jc})
        y2, c2 = ssm.ssm_decode(tp, _t(x), own, cfg, inplace=True)
        np.testing.assert_allclose(y2.numpy(), y.numpy(), **TOL)
        for name in own:
            assert c2[name] is own[name]
            np.testing.assert_allclose(own[name].numpy(), c[name].numpy(),
                                       **TOL)


# ----------------------------------------------------------------------
# the stack: forward, prefill, extend, cache_from_prefill, decode_step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("stack", ["mamba", "mixed"])
def test_forward_and_prefill_match_jax(stack, request):
    jcfg, jparams, cfg, params = request.getfixturevalue(stack)
    tokens, valid = _history(cfg, seed=6)
    valid[3, -1] = True  # a one-token row instead of an empty one
    tokens[3, -1] = 7
    want, _ = jax_forward(jparams, jcfg, jnp.asarray(tokens),
                          valid=jnp.asarray(valid))
    got = forward(params, cfg, _t(tokens), valid=_t(valid))
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               **TOL)
    want, jcaches = jax_prefill(jparams, jcfg, jnp.asarray(tokens),
                                valid=jnp.asarray(valid))
    got, caches = prefill(params, cfg, _t(tokens), valid=_t(valid))
    np.testing.assert_allclose(got.numpy()[:, -1], np.asarray(want)[:, -1],
                               **TOL)
    _assert_tree(caches, jcaches)
    last, _ = prefill(params, cfg, _t(tokens), valid=_t(valid),
                      logits_last_only=True)
    np.testing.assert_allclose(last.numpy()[:, 0], got.numpy()[:, -1], **TOL)


@pytest.mark.parametrize("stack", ["mamba", "mixed"])
def test_extend_matches_jax(stack, request):
    """The injection: a left-aligned suffix (full, partial, empty, one
    token) against a right-aligned prefill with an empty row."""
    jcfg, jparams, cfg, params = request.getfixturevalue(stack)
    tokens, valid = _history(cfg, seed=7)
    stoks, svalid = _suffix(cfg, seed=8)
    start = np.full(4, tokens.shape[1], np.int32)
    _, jpc = jax_prefill(jparams, jcfg, jnp.asarray(tokens),
                         valid=jnp.asarray(valid))
    want, jcaches = jax_extend(jparams, jcfg, jpc, jnp.asarray(stoks),
                               jnp.asarray(start), valid=jnp.asarray(svalid),
                               prefix_valid=jnp.asarray(valid))
    _, pc = prefill(params, cfg, _t(tokens), valid=_t(valid))
    got, caches = extend(params, cfg, pc, _t(stoks), _t(start),
                         valid=_t(svalid), prefix_valid=_t(valid))
    np.testing.assert_allclose(got.numpy()[svalid],
                               np.asarray(want)[svalid], **TOL)
    _assert_tree(caches, jcaches)


@pytest.mark.parametrize("stack", ["mamba", "mixed"])
def test_cache_from_prefill_and_decode_match_jax(stack, request):
    """prefill -> extend -> cache_from_prefill (bit-equal on the same
    input; SSM caches pass through) -> four decode steps, each step's
    logits and caches against the JAX ones; then the same steps in place
    on the caller's own cache."""
    jcfg, jparams, cfg, params = request.getfixturevalue(stack)
    tokens, valid = _history(cfg, seed=9)
    stoks, svalid = _suffix(cfg, seed=10)
    start = np.full(4, tokens.shape[1], np.int32)
    full_valid = np.concatenate([valid, svalid], 1)
    _, jpc = jax_prefill(jparams, jcfg, jnp.asarray(tokens),
                         valid=jnp.asarray(valid))
    _, jec = jax_extend(jparams, jcfg, jpc, jnp.asarray(stoks),
                        jnp.asarray(start), valid=jnp.asarray(svalid),
                        prefix_valid=jnp.asarray(valid))
    jdc = jax_cache_from_prefill(jcfg, jec, 48, valid=jnp.asarray(full_valid))
    ec = {k: {n: _t(a) for n, a in v.items()} for k, v in jec.items()}
    dc = cache_from_prefill(cfg, ec, 48, valid=_t(full_valid))
    _assert_tree(dc, jdc, exact=True)
    own = {k: {n: t.clone() for n, t in v.items()} for k, v in dc.items()}
    pos = start + svalid.sum(1).astype(np.int32)
    nxt = np.random.RandomState(11).randint(1, cfg.vocab_size, (4, 4))
    for i in range(4):
        tok = nxt[:, i:i + 1].astype(np.int32)
        want, jdc = jax_decode_step(jparams, jcfg, jdc, jnp.asarray(tok),
                                    jnp.asarray(pos + i))
        got, dc = decode_step(params, cfg, dc, _t(tok), _t(pos + i))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_tree(dc, jdc)
        got2, same = decode_step(params, cfg, own, _t(tok), _t(pos + i),
                                 inplace=True)
        assert same is own
        np.testing.assert_allclose(got2.numpy(), got.numpy(), **TOL)
    _assert_tree(own, jdc)


@pytest.mark.parametrize("stack", ["mamba", "mixed"])
def test_init_cache_matches_jax(stack, request):
    jcfg, _, cfg, params = request.getfixturevalue(stack)
    want = jax_init_cache(jcfg, 3, 40, dtype=jnp.float32)
    got = init_cache(cfg, 3, 40, torch.float32, "cpu")
    _assert_tree(got, want, exact=True)
    assert got["pos0" if stack == "mamba" else "pos1"]["state"].dtype \
        == torch.float32
    ranker = Ranker(cfg, params)
    _assert_tree(ranker.init_cache(3, 40), want, exact=True)


def test_moe_and_frontends_raise(mamba):
    """A ``vision`` or ``audio`` config runs the SSM stack after its
    frontend's prefix embeddings, as the JAX package does (forward and
    prefill logits within 1e-5, the same numpy embeddings on both sides).
    An MoE config does not raise: MoE stacks run (tests/test_torch_moe.py),
    and a pure SSM stack has no MLP for the MoE sub-config to replace."""
    jcfg, jparams, cfg, params = mamba
    rng = np.random.RandomState(5)
    toks = rng.randint(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    pfx = (rng.standard_normal((2, 4, cfg.d_model)) * 0.02).astype(np.float32)
    for frontend in ("vision", "audio"):
        jfront = dataclasses.replace(jcfg, frontend=frontend)
        front = dataclasses.replace(cfg, frontend=frontend)
        assert init_params(front, torch.Generator(), torch.float32,
                           "meta")["embed"]["table"].is_meta
        want, _ = jax_forward(jparams, jfront, jnp.asarray(toks),
                              prefix_embeds=jnp.asarray(pfx))
        got = forward(params, front, _t(toks), prefix_embeds=_t(pfx))
        assert got.shape == (2, 16, cfg.vocab_padded)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        wlast, _ = jax_prefill(jparams, jfront, jnp.asarray(toks),
                               prefix_embeds=jnp.asarray(pfx),
                               logits_last_only=True)
        last, _ = prefill(params, front, _t(toks), prefix_embeds=_t(pfx),
                          logits_last_only=True)
        np.testing.assert_allclose(last.numpy(), np.asarray(wlast), **TOL)
    with_moe = dataclasses.replace(cfg, moe=MoEConfig(n_experts=4, top_k=2))
    assert with_moe.mlp_kinds() == ("none",) * cfg.n_layers
    tokens = torch.ones((1, 4), dtype=torch.int32)
    np.testing.assert_array_equal(forward(params, with_moe, tokens).numpy(),
                                  forward(params, cfg, tokens).numpy())
