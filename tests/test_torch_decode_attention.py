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
from repro_torch.kernels.decode_attention.ref import ring_bias, ring_live


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

SLOTS, PITCH_MAX, LIST_SLOTS, MAX_HEADS = 32, 512, 1024, 32  # csrc constants


def _heads_per_cta(nkv, g, row_bytes):
    """``heads_per_cta``: the KV heads one CTA serves."""
    hb = 1
    while hb < nkv and 2 * hb * row_bytes <= PITCH_MAX \
            and 2 * hb * g <= MAX_HEADS:
        hb *= 2
    return hb


def _kernel_emulation(q, k, v, pos, stored, itemsize=4):
    """numpy emulation of ``csrc/decode_attention.cu`` in f32: per (row,
    block of KV heads) the CTA lists the live slots in ring order, 1024
    slots at a time, and visits them in stages of 32; each query head runs
    an online softmax from m = -inf over the stages (lanes past the stage's
    slots score -inf), its PV sums kept per slot group (slot jj in group
    jj % KS, KS = 32 / the 32-bit words of a head's row) and added at the
    end. A row with no live slot takes a second pass over every slot with
    the score -1e30."""
    b, _, nq, hd = q.shape
    w, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    hb = _heads_per_cta(nkv, g, hd * itemsize)
    ks = max(1, 32 // (hd * itemsize // 4))
    scale = np.float32(hd ** -0.5)
    out = np.zeros_like(q)
    for bb in range(b):
        p = pos[bb]
        live_end = w if p >= w else min(w, p + 1)
        for kv0 in range(0, nkv, hb):
            heads = range(kv0 * g, min(nkv, kv0 + hb) * g)
            m = {h: np.float32(-np.inf) for h in heads}
            l = {h: np.float32(0) for h in heads}
            acc = {h: np.zeros((ks, hd), np.float32) for h in heads}
            total = 0
            for dead in (False, True):
                if dead and total:
                    break
                end = w if dead else live_end
                for c0 in range(0, end, LIST_SLOTS):
                    span = np.arange(c0, min(c0 + LIST_SLOTS, end))
                    lst = span if dead else span[stored[bb, span]]
                    total += 0 if dead else len(lst)
                    for s0 in range(0, len(lst), SLOTS):
                        st = lst[s0:s0 + SLOTS]
                        for h in heads:
                            kvh = h // g
                            sc = np.full(SLOTS, -np.inf, np.float32)
                            sc[:len(st)] = np.float32(-1e30) if dead else \
                                (k[bb, st, kvh] @ q[bb, 0, h]) * scale
                            m_new = max(m[h], sc.max())
                            alpha = np.exp(np.float32(m[h] - m_new))
                            pr = np.exp(sc - m_new)
                            l[h] = l[h] * alpha + pr.sum()
                            m[h] = m_new
                            acc[h] *= alpha
                            for jj, slot in enumerate(st):
                                acc[h][jj % ks] += pr[jj] * v[bb, slot, kvh]
            for h in heads:
                out[bb, 0, h] = acc[h].sum(0) / l[h]
    return out


def _layout(kind, rng, b, w):
    """(pos, stored) of one of the ring layouts the kernel must handle.

    random: partial, exactly full and wrapped rings, ~80% stored, the last
        row with nothing stored (no live slot);
    path: the token path's rows: a left-padded prefill of 2w/3 slots whose
        tail (a history) is stored, a left-padded inject of w/6 slots with a
        few stored, then decode tokens; slots past pos hold stale stored
        flags (~10% of the ring live);
    one live: a single stored slot at or before pos;
    none live: nothing stored on any row;
    wrapped: pos >= W and every slot stored."""
    pos = rng.randint(0, 3 * w, b).astype(np.int32)
    stored = rng.rand(b, w) < 0.8
    if kind == "random":
        pos[:4] = [w // 3, w - 1, w, 2 * w + 1][:b]
        stored[np.arange(b), pos % w] = True  # written before it attends
        stored[-1] = False
    elif kind == "path":
        pre, inj = 2 * w // 3, w // 6
        hist = np.minimum(rng.geometric(1 / 32, b), pre)
        fresh = rng.randint(0, 9, b)
        pos = (pre + inj + rng.randint(0, min(10, w - pre - inj), b)
               ).astype(np.int32)
        slot = np.arange(w)[None]
        stored = ((slot >= pre - hist[:, None]) & (slot < pre)) \
            | ((slot >= pre + inj - fresh[:, None]) & (slot < pre + inj)) \
            | ((slot >= pre + inj) & (slot <= pos[:, None])) \
            | ((slot > pos[:, None]) & (rng.rand(b, w) < 0.5))
    elif kind == "one live":
        pos = rng.randint(0, w, b).astype(np.int32)
        stored = np.zeros((b, w), bool)
        stored[np.arange(b), rng.randint(0, w, b) % (pos + 1)] = True
        stored[:, w - 1] |= pos < w - 1  # past pos: dead
    elif kind == "none live":
        stored[:] = False
    elif kind == "wrapped":
        pos = (w + rng.randint(0, 2 * w, b)).astype(np.int32)
        stored[:] = True
    return pos, stored


@pytest.mark.parametrize("w,nq,nkv,hd,layout", [
    pytest.param(384, 8, 8, 32, "random", id="384-8-8-32"),  # serving shape
    pytest.param(100, 4, 2, 64, "random", id="100-4-2-64"),  # ragged stages
    pytest.param(70, 8, 2, 16, "random", id="70-8-2-16"),    # slot groups
    pytest.param(45, 8, 1, 128, "random", id="45-8-1-128"),  # 2 words a lane
    pytest.param(33, 16, 1, 32, "random", id="33-16-1-32"),  # g = 16
    pytest.param(384, 8, 8, 32, "path", id="384-8-8-32-path"),
    pytest.param(384, 8, 8, 32, "one live", id="384-8-8-32-one-live"),
    pytest.param(100, 4, 2, 64, "none live", id="100-4-2-64-none-live"),
    pytest.param(384, 8, 8, 32, "wrapped", id="384-8-8-32-wrapped"),
    pytest.param(2100, 4, 4, 16, "wrapped", id="2100-4-4-16-wrapped"),
])
def test_kernel_emulation_matches_plain(w, nq, nkv, hd, layout):
    """The kernel's algorithm gives the plain version's result on the ring
    layouts of ``_layout``; a row with no live slot gets the uniform
    average of V over all W slots. W = 2100 takes three list passes."""
    rng = np.random.RandomState(w + hd)
    b = 5
    q = rng.normal(size=(b, 1, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, w, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, w, nkv, hd)).astype(np.float32)
    pos, stored = _layout(layout, rng, b, w)
    live = ring_live(torch.from_numpy(pos), torch.from_numpy(stored)).numpy()
    want = decode_attention(*map(torch.from_numpy,
                                 (q, k, v, pos, stored))).numpy()
    got = _kernel_emulation(q, k, v, pos, stored)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    if layout == "path":
        assert 0.03 < live.mean() < 0.2
    if layout == "one live":
        assert (live.sum(1) == 1).all()
    if layout == "wrapped":
        assert live.all()
    for row in np.flatnonzero(~live.any(1)):
        uniform = np.repeat(v[row].mean(0), nq // nkv, axis=0)
        np.testing.assert_allclose(want[row, 0], uniform, atol=2e-5)
    assert layout not in ("random", "none live") or not live[-1].any()
