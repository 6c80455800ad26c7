"""The port's plain ``history_merge`` is bit for bit the JAX package's.

Held against the JAX op in both of its CPU forms (the Pallas kernel in
interpret mode and the XLA oracle) and against the row-by-row python
reference, on every case of ``test_history_merge_adversarial.py`` and on
random batches at the serving shapes. On a CPU tensor the op runs its
plain version; the CUDA kernel is held against that on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_history_merge_adversarial as adv
from repro.kernels.history_merge.ops import history_merge as jax_merge
from repro.kernels.history_merge.ref import history_merge_python_padded
from repro_torch.kernels.history_merge.ops import history_merge

ADVERSARIAL = [
    ("test_all_invalid_rows", {}),
    ("test_fully_duplicated_item_sets", {}),
    ("test_ts_tie_storm_realtime_beats_batch", {}),
    ("test_out_len_smaller_than_valid_count", {}),
    ("test_zero_length_buffers", {"side": "rt"}),
    ("test_zero_length_buffers", {"side": "batch"}),
    ("test_zero_length_buffers", {"side": "both"}),
    ("test_item_zero_collides_with_padding", {}),
    ("test_randomized_sweep_cross_impl", {}),
]


def _torch_merge(arrs, out_len):
    got = history_merge(*[torch.from_numpy(np.asarray(a, np.int32))
                          for a in arrs], out_len=out_len)
    for t in got:
        assert t.dtype == torch.int32 and t.shape == (len(arrs[0]), out_len)
    return [t.numpy() for t in got]


def test_adversarial_cases_all_listed():
    names = {n for n, f in inspect.getmembers(adv, inspect.isfunction)
             if n.startswith("test_")}
    assert names == {n for n, _ in ADVERSARIAL}


@pytest.mark.parametrize("case,kw", ADVERSARIAL,
                         ids=[n + "".join(f"[{v}]" for v in kw.values())
                              for n, kw in ADVERSARIAL])
def test_adversarial_case(case, kw, monkeypatch):
    """Runs the adversarial case with the port's merge added to the
    implementations that must agree exactly."""
    jax_impls_equal = adv._all_impls_equal
    calls = []

    def all_impls_equal(arrs, out_len):
        want = jax_impls_equal(arrs, out_len)
        for name, g, w in zip(("items", "ts", "valid"),
                              _torch_merge(arrs, out_len), want):
            np.testing.assert_array_equal(g, w, err_msg=f"torch:{name}")
        calls.append(out_len)
        return want

    monkeypatch.setattr(adv, "_all_impls_equal", all_impls_equal)
    getattr(adv, case)(**kw)
    assert calls


@pytest.mark.parametrize("b,lb,lr,k", [(4, 256, 64, 256), (3, 64, 16, 24),
                                       (2, 5, 0, 8), (2, 0, 7, 8)])
def test_serving_shapes_bit_equal(b, lb, lr, k):
    """Random rows at the serving shapes: heavy item and timestamp
    collisions, partly invalid, realtime events overlapping the batch."""
    rng = np.random.RandomState(b * 1000 + lb + lr)
    arrs = (rng.randint(0, 40, (b, lb)), rng.randint(0, 50, (b, lb)),
            (rng.rand(b, lb) < 0.8), rng.randint(0, 40, (b, lr)),
            rng.randint(40, 60, (b, lr)), (rng.rand(b, lr) < 0.8))
    arrs = [np.asarray(a, np.int32) for a in arrs]
    got = _torch_merge(arrs, k)
    want = history_merge_python_padded(*arrs, out_len=k)
    for impl in ("xla", "pallas_interpret"):
        ref = jax_merge(*[jnp.asarray(a) for a in arrs], out_len=k, impl=impl)
        for g, r, w in zip(got, ref, want):
            np.testing.assert_array_equal(np.asarray(r), w)
            np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# The CUDA kernel's algorithm, emulated
# ----------------------------------------------------------------------

def _pow2_at_least(n, lo=64):
    p = lo
    while p < n:
        p *= 2
    return p


def _hash(item, mask):
    """``hash_item``: a multiplicative hash of the item's 32 bits."""
    h = (int(item) & 0xFFFFFFFF) * 2654435761 & 0xFFFFFFFF
    return (h ^ (h >> 16)) & mask


def _bitonic_descending(keys):
    """The kernel's bitonic network over a power-of-two array of uint64."""
    keys = keys.copy()
    p = len(keys)
    q = np.arange(p // 2)
    kk = 2
    while kk <= p:
        j = kk // 2
        while j > 0:
            a = ((q & ~(j - 1)) << 1) | (q & (j - 1))
            c = a | j
            x, y = keys[a], keys[c]
            swap = ((a & kk) == 0) == (x < y)
            keys[a], keys[c] = np.where(swap, y, x), np.where(swap, x, y)
            j //= 2
        kk *= 2
    return keys


def _merge_emulation(bi, bt, bv, ri, rt, rv, out_len):
    """numpy emulation of ``csrc/history_merge.cu``: per row, 64-bit
    freshness keys (ts with its sign bit flipped) << 32 | concatenated
    index; a linear-probing table keyed by item + 1 keeps each item's
    largest key; an event is alive iff valid and its key is the table's;
    the alive keys (0 for the rest) go through the bitonic network in
    descending order, and slot K - 1 - r takes the r-th for r < min(K, A)."""
    items = np.concatenate([bi, ri], 1).astype(np.int32)
    ts = np.concatenate([bt, rt], 1).astype(np.int32)
    valid = np.concatenate([bv, rv], 1) > 0
    b, n = items.shape
    k = out_len
    p, size = _pow2_at_least(n), _pow2_at_least(2 * n)
    keys = (((ts.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
             << np.uint64(32)) | np.arange(n, dtype=np.uint64))
    outs = [np.zeros((b, k), np.int32) for _ in range(3)]
    for row in range(b):
        t_item = np.zeros(size, np.uint64)
        t_key = np.zeros(size, np.uint64)
        slot = np.zeros(n, np.int64)
        for i in np.flatnonzero(valid[row]):
            tag = np.uint64((int(items[row, i]) & 0xFFFFFFFF) + 1)
            s = _hash(items[row, i], size - 1)
            while t_item[s] not in (0, tag):
                s = (s + 1) & (size - 1)
            t_item[s] = tag
            t_key[s] = max(t_key[s], keys[row, i])
            slot[i] = s
        alive = valid[row] & (t_key[slot] == keys[row])
        sort = np.zeros(p, np.uint64)
        sort[:n][alive] = keys[row][alive]
        ranked = _bitonic_descending(sort)
        for r in range(min(k, int(alive.sum()))):
            x = int(ranked[r])
            outs[0][row, k - 1 - r] = items[row, x & 0xFFFFFFFF]
            outs[1][row, k - 1 - r] = np.uint32((x >> 32) ^ 0x80000000).view(
                np.int32)
            outs[2][row, k - 1 - r] = 1
    return outs


@pytest.mark.parametrize("case,kw", ADVERSARIAL,
                         ids=[n + "".join(f"[{v}]" for v in kw.values())
                              for n, kw in ADVERSARIAL])
def test_kernel_emulation_adversarial_case(case, kw, monkeypatch):
    """The kernel's hash-and-sort algorithm, bit for bit against the JAX
    op (both CPU forms), the python reference and the port's plain version
    on every adversarial case."""
    jax_impls_equal = adv._all_impls_equal
    calls = []

    def all_impls_equal(arrs, out_len):
        want = jax_impls_equal(arrs, out_len)
        got = _merge_emulation(*arrs, out_len)
        for name, g, t, w in zip(("items", "ts", "valid"), got,
                                 _torch_merge(arrs, out_len), want):
            np.testing.assert_array_equal(g, w, err_msg=f"emulation:{name}")
            np.testing.assert_array_equal(t, w, err_msg=f"torch:{name}")
        calls.append(out_len)
        return want

    monkeypatch.setattr(adv, "_all_impls_equal", all_impls_equal)
    getattr(adv, case)(**kw)
    assert calls


@pytest.mark.parametrize("b,lb,lr,k,span", [
    (4, 40, 12, 24, "extremes"),    # ts at INT_MIN / INT_MAX, index 0 too
    (4, 40, 12, 64, "negative"),    # negative ts around 0; K > N
    (2, 300, 64, 256, "negative"),  # the serving shape's N, a 512 network
])
def test_kernel_emulation_int32_extremes(b, lb, lr, k, span):
    """Sign-flipped packing at int32's ends: ts of INT_MIN (whose key can
    be 0, the padding value) and INT_MAX, and negative ts, bit for bit
    against the JAX op, the python reference and the plain version."""
    rng = np.random.RandomState(lb + lr + k)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    if span == "extremes":
        pick = np.array([lo, lo + 1, -1, 0, 1, hi - 1, hi], np.int64)
        bt, rt = pick[rng.randint(0, 7, (b, lb))], pick[rng.randint(0, 7, (b, lr))]
        bt[:, 0] = lo  # index 0 at INT_MIN: the key 0
    else:
        bt, rt = rng.randint(-50, 50, (b, lb)), rng.randint(-20, 60, (b, lr))
    arrs = [np.asarray(a, np.int32) for a in (
        rng.randint(0, 12, (b, lb)), bt, rng.rand(b, lb) < 0.8,
        rng.randint(0, 12, (b, lr)), rt, rng.rand(b, lr) < 0.8)]
    arrs[2][:, 0] = 1
    arrs[0][:, 0] = 99  # an item of its own: alive, with the key 0
    want = history_merge_python_padded(*arrs, out_len=k)
    got = _merge_emulation(*arrs, k)
    for impl in ("xla", "pallas_interpret"):
        ref = jax_merge(*[jnp.asarray(a) for a in arrs], out_len=k, impl=impl)
        for r, w in zip(ref, want):
            np.testing.assert_array_equal(np.asarray(r), w)
    for g, t, w in zip(got, _torch_merge(arrs, k), want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(t, w)
    if span == "extremes":  # the key-0 event is kept, the oldest alive
        first = np.argmax(want[2], axis=1)
        assert (want[0][np.arange(b), first] == 99).all()
        assert (want[1][np.arange(b), first] == lo).all()
