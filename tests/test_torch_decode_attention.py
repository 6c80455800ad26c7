"""The port's ``decode_attention`` plain version against the JAX package,
and a CPU emulation of the CUDA kernel's algorithm against the plain
version.

Tolerances are ``tests/test_kernels.py``'s: 2e-5 in fp32 (different
summation order), 3e-2 in bf16 (rounding of bf16 inputs and
probabilities at different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ops import ring_bias as jax_ring_bias
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (NEG_INF, ring_bias,
                                                      ring_live)


def _tol(dtype):
    return dict(atol=3e-2, rtol=3e-2) if dtype == jnp.bfloat16 else \
        dict(atol=2e-5, rtol=2e-5)


def _torch(a, dtype):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("w,nq,nkv,hd,dtype", [
    (512, 4, 2, 64, jnp.float32),
    (1024, 8, 1, 128, jnp.float32),
    (512, 4, 4, 64, jnp.bfloat16),
])
def test_plain_matches_pallas_interpret_and_jax_ref(w, nq, nkv, hd, dtype):
    """``test_kernels.py``'s cases, same inputs: partial, half and wrapped
    rings, every slot stored."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    b = 3
    q = jax.random.normal(k1, (b, 1, nq, hd), jnp.float32).astype(dtype)
    kc = jax.random.normal(k2, (b, w, nkv, hd), jnp.float32).astype(dtype)
    vc = jax.random.normal(k3, (b, w, nkv, hd), jnp.float32).astype(dtype)
    pos = jnp.array([10, w // 2, 2 * w], jnp.int32)
    pallas = jax_decode(q, kc, vc, pos, block_k=256, interpret=True)
    ref = jnp.moveaxis(jax_decode_ref(
        jnp.moveaxis(q, 1, 2), jnp.moveaxis(kc, 1, 2), jnp.moveaxis(vc, 1, 2),
        jax_ring_bias(pos, w)), 2, 1)
    got = decode_attention(_torch(q, dtype), _torch(kc, dtype),
                           _torch(vc, dtype), torch.from_numpy(np.array(pos)),
                           torch.ones((b, w), dtype=torch.bool))
    for want in (pallas, ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("w", [1, 8, 384])
def test_ring_bias_matches_jax(w):
    pos = np.array([0, w - 1, w, 3 * w + 2, w // 2], np.int32)
    want = np.asarray(jax_ring_bias(jnp.asarray(pos), w))
    got = ring_bias(torch.from_numpy(pos), w).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_unstored_slots_match_the_jax_masked_contraction():
    """Some ``stored`` False (left-padded prefills): the plain version
    equals the JAX package's ``attention_decode`` contraction, written
    out here on the JAX side with its ring validity AND ``stored``."""
    rng = np.random.RandomState(0)
    b, w, nq, nkv, hd = 5, 40, 4, 2, 16
    q = rng.normal(size=(b, 1, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, w, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, w, nkv, hd)).astype(np.float32)
    stored = rng.rand(b, w) < 0.5
    stored[:, 0] = True
    pos = np.array([0, 5, 39, 40, 123], np.int32)
    idx = jnp.arange(w, dtype=jnp.int32)[None, :]
    valid = ((idx <= pos[:, None]) | (pos[:, None] >= w)) & stored
    kk = jnp.repeat(k, nq // nkv, axis=2)
    vv = jnp.repeat(v, nq // nkv, axis=2)
    s = jnp.einsum("bqnh,bsnh->bnqs", q, kk,
                   preferred_element_type=jnp.float32) * hd ** -0.5
    s = jnp.where(valid[:, None, None, :], s, -1e30)
    want = jnp.einsum("bnqs,bsnh->bqnh", jax.nn.softmax(s, axis=-1), vv)
    got = decode_attention(*map(torch.from_numpy, (q, k, v, pos, stored)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ----------------------------------------------------------------------
# The CUDA kernel's algorithm, emulated
# ----------------------------------------------------------------------

WARPS, TILE, STAGE_BYTES, MAX_HEADS_PER_WARP = 4, 32, 36 * 1024, 4


def _stage_tiles(hd):
    """``Shape<HD>::SMAX``: 32-key tiles staged at once."""
    raw = STAGE_BYTES // (2 * TILE * (hd + 1) * 4)
    return max(1, min(raw, WARPS))


def _online(m, l, acc, s, vt):
    """One warp's update over one tile of 32 scores."""
    m_new = max(m, s.max())
    alpha = np.exp(np.float32(m - m_new))
    p = np.exp(s - m_new)
    return m_new, l * alpha + p.sum(), acc * alpha + p @ vt


def _kernel_emulation(q, k, v, pos, stored):
    """numpy emulation of ``csrc/decode_attention.cu``: per (row, KV head)
    the CTA steps over W in S tiles of 32 keys; warp w owns query head
    w % g of split w // g (S > 1) or heads w, w + 4, ... (S == 1), runs
    an online softmax from m = -1e30 with dead slots at -1e30 and keys
    past W at -inf, and the S splits of a head merge at the end."""
    b, _, nq, hd = q.shape
    w, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    assert g <= WARPS * MAX_HEADS_PER_WARP
    S = max(1, min(_stage_tiles(hd), WARPS // g))
    out = np.zeros_like(q)
    for bb in range(b):
        live = np.array([(j <= pos[bb] or pos[bb] >= w) and stored[bb, j]
                         for j in range(w)])
        for kvh in range(nkv):
            state = {}  # (head, split) -> (m, l, acc)
            for warp in range(WARPS):
                if S > 1:
                    owned = [(warp % g, warp // g)] if warp < g * S else []
                else:
                    owned = [(h, 0) for h in range(warp, g, WARPS)]
                for h, split in owned:
                    m, l = np.float32(NEG_INF), np.float32(0)
                    acc = np.zeros(hd, np.float32)
                    for k0 in range(0, w, S * TILE):
                        keys = k0 + split * TILE + np.arange(TILE)
                        s = np.full(TILE, -np.inf, np.float32)
                        vt = np.zeros((TILE, hd), np.float32)
                        ok = keys < w
                        kin = keys[ok]
                        dots = k[bb, kin, kvh] @ q[bb, 0, kvh * g + h] \
                            * np.float32(hd ** -0.5)
                        s[ok] = np.where(live[kin], dots, NEG_INF)
                        vt[ok] = v[bb, kin, kvh]
                        m, l, acc = _online(m, l, acc, s, vt)
                    state[h, split] = (m, l, acc)
            for h in range(g):
                parts = [state[h, sp] for sp in range(S)]
                mm = max(p[0] for p in parts)
                f = [np.exp(np.float32(p[0] - mm)) for p in parts]
                ll = sum(p[1] * fi for p, fi in zip(parts, f))
                acc = sum(p[2] * fi for p, fi in zip(parts, f))
                out[bb, 0, kvh * g + h] = acc / ll
    return out


@pytest.mark.parametrize("w,nq,nkv,hd", [
    (384, 8, 8, 32),    # the serving shape: g = 1, four key splits
    (100, 4, 2, 64),    # g = 2, two splits, W not a multiple of the step
    (70, 8, 2, 16),     # g = 4, one head per warp
    (45, 8, 1, 128),    # g = 8, two heads per warp, one tile staged
    (33, 16, 1, 32),    # g = 16, the most the kernel takes
])
def test_kernel_emulation_matches_plain(w, nq, nkv, hd):
    """The kernel's algorithm gives the plain version's result on partial,
    exactly full and wrapped rings, with unstored slots and a row with no
    live slot at all (the uniform average of V over all W slots)."""
    rng = np.random.RandomState(w + hd)
    b = 5
    q = rng.normal(size=(b, 1, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, w, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, w, nkv, hd)).astype(np.float32)
    pos = np.array([w // 3, w - 1, w, 2 * w + 1, w // 2], np.int32)
    stored = rng.rand(b, w) < 0.8
    stored[np.arange(b), pos % w] = True  # written before it attends
    stored[4] = False                     # no live slot
    want = decode_attention(*map(torch.from_numpy,
                                 (q, k, v, pos, stored))).numpy()
    assert not ring_live(torch.from_numpy(pos),
                         torch.from_numpy(stored))[4].any()
    got = _kernel_emulation(q, k, v, pos, stored)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    uniform = np.repeat(v[4].mean(0), nq // nkv, axis=0)
    np.testing.assert_allclose(want[4, 0], uniform, atol=2e-5)
