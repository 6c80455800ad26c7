"""The port's dense ranker against the JAX package's, on ``tiny-test``.

Weights are made by the JAX ``init_params`` and converted with
``params_from_numpy``; inputs come from numpy seeds. Everything is fp32
with TF32 off. Tolerance 1e-5 absolute and relative: XLA and torch order
their f32 sums differently, which moves logits of magnitude ~1 by a few
1e-6. The flash-attention plain version is held against the JAX Pallas
kernel (interpret mode) at ``test_kernels.py``'s tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_model_config
from torch_port import port_cfg
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models.attention import attention_full as jax_attention_full
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init_params
from repro.models.model import param_shapes as jax_param_shapes
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask
from repro_torch.models.attention import attention_full
from repro_torch.models.model import Ranker, forward, init_params, param_shapes
from repro_torch.weights import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_model_config()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = port_cfg(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, b=5, s=24, seed=0):
    """Tokens with left padding: row 1 partly padded, row 2 all padding
    (a user with no history), the rest full."""
    rng = np.random.RandomState(seed)
    valid = np.ones((b, s), bool)
    valid[1, :9] = False
    valid[2] = False
    valid[3, :s - 1] = False
    tokens = np.where(valid, rng.randint(1, cfg.vocab_size, (b, s)), 0)
    return tokens.astype(np.int32), valid


@pytest.mark.parametrize("name", ["tiny-test", "itfi-ranker"])
def test_param_shapes_match_jax(name):
    from repro.configs.base import get_config as jax_get_config
    jcfg = tiny_model_config() if name == "tiny-test" else jax_get_config(name)
    cfg = port_cfg(jcfg)
    if name == "itfi-ranker":
        assert get_config(name) == cfg
    want = jax.tree.map(lambda x: tuple(x.shape), jax_param_shapes(jcfg))
    assert param_shapes(cfg) == want
    got = init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                      "cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), got) == want


def test_params_from_numpy_bf16_bits_and_checks(tiny):
    jcfg, _, cfg, _ = tiny
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))  # bf16
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(tree, cfg, device="cpu")
    wq = params["blocks"]["pos0"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy(),
        tree["blocks"]["pos0"]["attn"]["wq"].view(np.int16))
    tree["blocks"]["pos0"]["attn"]["wq"] = tree["blocks"]["pos0"]["attn"][
        "wq"][:, :, :1]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(tree, cfg, device="cpu")


def test_attention_full_matches_jax(tiny):
    jcfg, jparams, cfg, params = tiny
    tokens, valid = _batch(cfg)
    rng = np.random.RandomState(1)
    x = rng.normal(size=(*tokens.shape, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(tokens.shape[1], dtype=np.int32),
                  (tokens.shape[0], 1))
    lp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["attn"])
    jy, jkv = jax_attention_full(lp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                 valid=jnp.asarray(valid))
    tp = {k: v[0] for k, v in params["blocks"]["pos0"]["attn"].items()}
    y, kv = attention_full(tp, torch.from_numpy(x), torch.from_numpy(pos),
                           cfg, valid=torch.from_numpy(valid))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(kv[name].numpy(), np.asarray(jkv[name]),
                                   **TOL)


def test_forward_matches_jax(tiny):
    jcfg, jparams, cfg, params = tiny
    tokens, valid = _batch(cfg, seed=2)
    want, _ = jax_forward(jparams, jcfg, jnp.asarray(tokens),
                          valid=jnp.asarray(valid))
    got = forward(params, cfg, torch.from_numpy(tokens),
                  valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ranker = Ranker(cfg, params)
    assert "params.blocks.pos0.attn.wq" in ranker.state_dict()
    last = ranker(torch.from_numpy(tokens), valid=torch.from_numpy(valid),
                  last_only=True)
    assert last.shape == (tokens.shape[0], 1, cfg.vocab_padded)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:], **TOL)


@pytest.mark.parametrize("s,nq,nkv,hd,window,dtype", [
    (256, 4, 2, 64, 0, jnp.float32),
    (384, 8, 2, 128, 0, jnp.float32),
    (256, 4, 1, 64, 128, jnp.float32),
    (256, 4, 2, 64, 0, jnp.bfloat16),
])
def test_flash_plain_matches_pallas_interpret(s, nq, nkv, hd, window, dtype):
    """``test_kernels.py``'s causal and window cases, same inputs."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    b = 2
    q = jax.random.normal(k1, (b, s, nq, hd), jnp.float32).astype(dtype)
    k = jax.random.normal(k2, (b, s, nkv, hd), jnp.float32).astype(dtype)
    v = jax.random.normal(k3, (b, s, nkv, hd), jnp.float32).astype(dtype)
    want = jax_flash(q, k, v, causal=True, window=window, block_q=128,
                     block_k=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        for a in (q, k, v))
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    got = flash_attention(tq, tk, tv, pos, pos,
                          torch.ones((b, s), dtype=torch.bool), window=window)
    tol = dict(atol=3e-2, rtol=3e-2) if dtype == jnp.bfloat16 \
        else dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _kernel_tile_loop(q, k, v, mask, bk=32):
    """numpy emulation of ``csrc/flash_attention.cu``'s per-row loop:
    online softmax from m = -1e30 over every key tile of ``bk`` keys, a
    masked score set to -1e30 and keys past Sk to -inf."""
    b, sq, nq, hd = q.shape
    sk, g = k.shape[1], nq // k.shape[2]
    out = np.zeros_like(q)
    for bb in range(b):
        for h in range(nq):
            for i in range(sq):
                m, l, acc = np.float32(NEG_INF), np.float32(0), np.zeros(hd,
                                                                       np.float32)
                for k0 in range(0, sk, bk):
                    s = np.full(bk, -np.inf, np.float32)
                    n = min(bk, sk - k0)
                    dots = k[bb, k0:k0 + n, h // g] @ q[bb, i, h] * hd ** -0.5
                    s[:n] = np.where(mask[bb, i, k0:k0 + n], dots, NEG_INF)
                    m_new = max(m, s.max())
                    alpha = np.exp(m - m_new)
                    p = np.exp(s - m_new)
                    l = l * alpha + p.sum()
                    vt = np.zeros((bk, hd), np.float32)
                    vt[:n] = v[bb, k0:k0 + n, h // g]
                    acc = acc * alpha + p @ vt
                    m = m_new
                out[bb, i, h] = acc / l
    return out


@pytest.mark.parametrize("sq,sk,window", [(20, 20, 0), (16, 45, 0),
                                          (33, 33, 6)])
def test_kernel_tile_loop_matches_plain(sq, sk, window):
    """The kernel's algorithm gives the plain version's result, including
    rows with no attendable key (the uniform average of V over all Sk keys,
    which a dead-block skip would break) and Sk beyond Sq and beyond a
    multiple of the tile."""
    rng = np.random.RandomState(sq + sk)
    b, nq, nkv, hd = 3, 4, 2, 16
    q = rng.normal(size=(b, sq, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, nkv, hd)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32), (b, sq))
    kpos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk))
    kvalid = np.ones((b, sk), bool)
    kvalid[1, :sk // 2] = False          # left padding
    kvalid[2] = False                    # no history at all
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tqp, tkp, tkv = map(torch.from_numpy, (qpos.copy(), kpos.copy(), kvalid))
    want = flash_attention(tq, tk, tv, tqp, tkp, tkv, window=window).numpy()
    mask = attention_mask(tqp, tkp, tkv, window).numpy()
    assert not mask[2].any()
    got = _kernel_tile_loop(q, k, v, mask)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(want[2], np.broadcast_to(
        v[2].mean(0).repeat(nq // nkv, 0), want[2].shape), atol=2e-5)
