"""The schedule of ``csrc/flash_attention.cu``, emulated on the CPU.

The CUDA kernel cannot run here, so ``kernel_schedule`` repeats its
algorithm in numpy at small shapes: work items of 16 query rows of one
head, key tiles of 32 keys, a key tile skipped when no (query, key) pair in
it can be live (judged from the min and max positions of the tile's valid
keys and of the item's rows), an online softmax in which a masked key gets
p = 0, a per-row flag for "has seen a live key", and the mean of V over
all Sk keys for a row that never does. On the bf16 path P is rounded to
bf16 before the PV product, as the kernel's tensor-core product takes it.

The emulation is held against the plain version ``attention_ref`` at 2e-5
(fp32: another summation order) and 3e-2 (bf16: the plain version rounds
the normalised probabilities, the kernel the unnormalised ones), on the
cases where a skip or a dead row could go wrong. The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

BQ, BK = 16, 32             # the kernel's query rows per item, keys per tile
NEG_INF = np.float32(-1e30)


def _bf16(x):
    """Round an f32 array to bf16 (nearest even) and back."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def kernel_schedule(q, k, v, qpos, kpos, kvalid, window=0, bf16=False):
    """(out, visits, q_reads) of the kernel's algorithm. q (B, Sq, nq, hd),
    k/v (B, Sk, nkv, hd) as f32 arrays (bf16 values on the bf16 path);
    visits: the set of (b, head, query tile, key tile) computed; q_reads:
    the set of (b, head, query tile) whose Q was read."""
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    group, scale = nq // nkv, np.float32(hd ** -0.5)
    nqt, nkt = -(-sq // BQ), -(-sk // BK)
    out = np.zeros_like(q)
    visits, q_reads = set(), set()
    for bb in range(b):
        for kvh in range(nkv):
            mean = v[bb, :, kvh].astype(np.float32).sum(0) / np.float32(sk)
            if bf16:
                mean = _bf16(mean)
            for hh in range(group):
                h = kvh * group + hh
                for qt in range(nqt):
                    rows = np.arange(qt * BQ, min(sq, qt * BQ + BQ))
                    qp = qpos[bb, rows]
                    m = np.full(len(rows), NEG_INF, np.float32)
                    l = np.zeros(len(rows), np.float32)
                    acc = np.zeros((len(rows), hd), np.float32)
                    seen = np.zeros(len(rows), bool)
                    for kt in range(nkt):
                        keys = np.arange(kt * BK, min(sk, kt * BK + BK))
                        ok = kvalid[bb, keys]
                        if not ok.any():
                            continue
                        kp = kpos[bb, keys]
                        if kp[ok].min() > qp.max():
                            continue
                        if window > 0 and kp[ok].max() <= qp.min() - window:
                            continue
                        visits.add((bb, h, qt, kt))
                        q_reads.add((bb, h, qt))
                        s = (q[bb, rows, h] @ k[bb, keys, kvh].T) * scale
                        live = ok[None] & (kp[None] <= qp[:, None])
                        if window > 0:
                            live &= (qp[:, None] - kp[None]) < window
                        tmax = np.where(live, s, NEG_INF).max(1)
                        m_new = np.maximum(m, tmax)
                        alpha = np.exp(m - m_new)
                        p = np.exp(np.where(live, s - m_new[:, None],
                                            -np.inf))
                        l = l * alpha + p.sum(1)
                        pv = _bf16(p) if bf16 else p
                        acc = acc * alpha[:, None] + pv @ v[bb, keys, kvh]
                        m = m_new
                        seen |= live.any(1)
                    o = np.where(seen[:, None],
                                 acc / np.where(seen, l, 1)[:, None],
                                 mean[None])
                    out[bb, rows, h] = _bf16(o) if bf16 else o
    return out, visits, q_reads


def _case(name, seed=0):
    """(b, sq, sk, nq, nkv, hd, window) and the positions and key mask."""
    b, sq, sk, nq, nkv, hd, window = {
        "left padding": (3, 40, 40, 4, 2, 16, 0),
        "no valid key": (2, 24, 24, 2, 2, 16, 0),
        "dead rows in a live tile": (2, 48, 48, 2, 1, 16, 0),
        "Sk > Sq, ragged tiles": (2, 20, 75, 4, 2, 32, 0),
        "window": (2, 100, 100, 4, 4, 16, 9),
        "MQA": (2, 33, 33, 8, 1, 16, 0),
        "non-monotone positions": (3, 37, 37, 4, 2, 16, 0),
        "non-monotone with a window": (2, 50, 50, 2, 1, 16, 12),
        "extend, invalid suffix tail": (4, 16, 80, 4, 4, 16, 0),
    }[name]
    rng = np.random.RandomState(seed)
    kpos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    qpos = kpos[:, sk - sq:].copy()
    kvalid = np.ones((b, sk), bool)
    if name == "left padding":
        kvalid[0, :25] = False
        kvalid[1, :39] = False
    elif name == "no valid key":
        kvalid[1] = False
    elif name == "dead rows in a live tile":
        kvalid[:, :21] = False           # rows 16..20 dead, 21..31 live
    elif name == "Sk > Sq, ragged tiles":
        kvalid[0, :60] = False
        kvalid[1, 70:] = False
    elif name.startswith("non-monotone"):
        for r in range(b):
            perm = rng.permutation(sk).astype(np.int32)
            kpos[r], qpos[r] = perm, perm[sk - sq:]
        kvalid[0, rng.permutation(sk)[: sk // 2]] = False
        kvalid[-1, rng.permutation(sk)[: sk - 3]] = False
    elif name == "extend, invalid suffix tail":
        # a 64-slot prefix left-padded by history length, then a suffix
        # of 16 positions whose first `fresh` tokens are real
        hist, fresh = np.array([0, 10, 64, 0]), np.array([3, 0, 16, 0])
        kvalid[:, :64] = np.arange(64)[None] >= (64 - hist)[:, None]
        kvalid[:, 64:] = np.arange(16)[None] < fresh[:, None]
        qpos = (64 + np.arange(16, dtype=np.int32))[None].repeat(b, 0)
        kpos[:, 64:] = qpos
    return (b, sq, sk, nq, nkv, hd, window), qpos, kpos, kvalid


CASES = ["left padding", "no valid key", "dead rows in a live tile",
         "Sk > Sq, ragged tiles", "window", "MQA", "non-monotone positions",
         "non-monotone with a window", "extend, invalid suffix tail"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES)
def test_schedule_matches_plain(name, dtype):
    (b, sq, sk, nq, nkv, hd, window), qpos, kpos, kvalid = _case(name)
    rng = np.random.RandomState(len(name))
    tq, tk, tv = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        dtype) for s in ((b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd)))
    tpos = [torch.from_numpy(a) for a in (qpos, kpos, kvalid)]
    want = attention_ref(tq, tk, tv, *tpos, window=window).float().numpy()
    got, _, _ = kernel_schedule(
        *(t.float().numpy() for t in (tq, tk, tv)), qpos, kpos, kvalid,
        window, bf16=dtype == torch.bfloat16)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_schedule_skips_dead_tiles_on_left_padding():
    """Keys 0..99 of 128 invalid: key tiles 0-2 hold no valid key, and
    query tiles 0-5 (rows 0..95) see none of keys 100..127. So only query
    tiles 6 and 7 read Q, each against key tile 3 alone; rows 96..99, dead
    inside a live tile, and rows 0..95 get the mean of V."""
    b, s, nq, nkv, hd = 1, 128, 2, 1, 16
    rng = np.random.RandomState(0)
    q = rng.normal(size=(b, s, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, nkv, hd)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    kvalid = np.arange(s)[None] >= 100
    got, visits, q_reads = kernel_schedule(q, k, v, pos, pos, kvalid)
    assert visits == {(0, h, qt, 3) for h in range(nq) for qt in (6, 7)}
    assert q_reads == {(0, h, qt) for h in range(nq) for qt in (6, 7)}
    want = attention_ref(*map(torch.from_numpy, (q, k, v, pos, pos,
                                                 kvalid))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got[0, :100], np.broadcast_to(
        v[0].mean(0), (100, nq, hd)), atol=2e-5)


def test_schedule_skips_interior_tiles_under_a_window():
    """With a window of 8 and 32-key tiles, query tile qt (rows 16qt ..
    16qt + 15) can reach only the key tiles that hold keys 16qt - 7 ..
    16qt + 15: at most two, never one far behind."""
    b, s, nq, hd, window = 1, 160, 1, 16, 8
    rng = np.random.RandomState(1)
    q, k, v = (rng.normal(size=(b, s, nq, hd)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(s, dtype=np.int32)[None]
    kvalid = np.ones((b, s), bool)
    got, visits, _ = kernel_schedule(q, k, v, pos, pos, kvalid, window)
    for qt in range(s // BQ):
        lo, hi = max(0, BQ * qt - window + 1) // BK, (BQ * qt + BQ - 1) // BK
        assert {kt for (_, _, t, kt) in visits if t == qt} == set(
            range(lo, hi + 1))
    want = attention_ref(*map(torch.from_numpy, (q, k, v, pos, pos, kvalid)),
                         window=window).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_schedule_all_dead_item_reads_no_q():
    """A batch row with no valid key: every item writes the V mean of its
    KV head without reading Q or computing a tile."""
    b, s, nq, nkv, hd = 2, 40, 4, 2, 16
    rng = np.random.RandomState(2)
    q = rng.normal(size=(b, s, nq, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, nkv, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    kvalid = np.ones((b, s), bool)
    kvalid[1] = False
    got, visits, q_reads = kernel_schedule(q, k, v, pos, pos, kvalid)
    assert not any(r[0] == 1 for r in visits | q_reads)
    mean = v[1].mean(0).repeat(nq // nkv, 0)          # (nq, hd)
    np.testing.assert_allclose(got[1], np.broadcast_to(mean, (s, nq, hd)),
                               atol=2e-5)
