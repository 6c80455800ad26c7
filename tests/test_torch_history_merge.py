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
