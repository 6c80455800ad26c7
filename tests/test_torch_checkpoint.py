"""The port's checkpoint format (``repro_torch.training.checkpoint``) and its
pure-Python msgpack codec (``training/_msgpack.py``) against the JAX
package's and ``msgpack`` itself.

* The codec's ``packb`` must give ``msgpack.packb(obj, use_bin_type=True)``
  byte for byte, and its ``unpackb`` read what ``msgpack.unpackb`` reads,
  over objects drawn by hypothesis from every type the formats use (nil,
  bool, int over the whole 64-bit range, float64, str, bin, arrays and
  str-keyed maps), at every length boundary of the encoding.
* A checkpoint written by the JAX package loads in the port, and the
  reverse, bit for bit, bf16 leaves included; for the same tree both
  packages write the same bytes.
* The write is atomic (a failed rename leaves the old file and no
  litter), and a truncated, corrupt or other-version file raises, as
  ``tests/test_training.py`` holds the JAX package to.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import tiny_model_config
from repro.models.model import init_params as jax_init_params
from repro.training import checkpoint as jax_ckpt
from repro_torch.models.common import flatten_with_keystr
from repro_torch.training import _msgpack, checkpoint
from repro_torch.weights import params_from_numpy
from torch_port import port_cfg

SCALARS = (st.none() | st.booleans()
           | st.integers(-2 ** 63, 2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=300)
           | st.binary(max_size=300))
DOCS = st.recursive(
    SCALARS,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=40), inner,
                                     max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(DOCS)
def test_codec_equals_msgpack(doc):
    want = msgpack.packb(doc, use_bin_type=True)
    got = _msgpack.packb(doc)
    assert got == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(
        want, raw=False, strict_map_key=False)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 255, 256, 65535,
                               65536])
def test_codec_length_boundaries(n):
    """Each length form of str, bin, array and map at its edges; ints at
    each width's edges; floats as float64; tuples as arrays."""
    for doc in ("x" * n, b"\x01" * n, list(range(min(n, 300))) * (n // 300
                                                                  + 1),
                {str(i): i for i in range(n)}):
        if isinstance(doc, list):
            doc = doc[:n]
        want = msgpack.packb(doc, use_bin_type=True)
        assert _msgpack.packb(doc) == want
        assert _msgpack.unpackb(want) == msgpack.unpackb(
            want, raw=False, strict_map_key=False)
    for k in (7, 8, 15, 16, 31, 32, 63, 64):
        for v in (2 ** k - 1, 2 ** k, -2 ** k, -2 ** k - 1, 1.5 * k):
            if -2 ** 63 <= v < 2 ** 64:
                assert _msgpack.packb(v) == msgpack.packb(v, use_bin_type=True)
    assert _msgpack.packb((1, "a")) == msgpack.packb((1, "a"),
                                                     use_bin_type=True)


def test_codec_refuses_what_msgpack_refuses():
    with pytest.raises(TypeError):
        _msgpack.packb(np.int64(3))
    with pytest.raises(OverflowError):
        _msgpack.packb(2 ** 64)
    for bad in (b"\x92\x01", b"\xc4\x05ab", b"\x01\x02", b"\xc1", b""):
        with pytest.raises(ValueError):
            _msgpack.unpackb(bad)


def _trees():
    """The same tree in both packages: the bf16 ``tiny-test`` params
    (the JAX package's default dtype), an int leaf, a bool leaf, nested
    Python values, None and a tuple."""
    jcfg = tiny_model_config()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))    # bf16 leaves
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), port_cfg(jcfg),
                           device="cpu")
    ids = np.arange(-3, 9, dtype=np.int32).reshape(3, 4)
    mask = np.array([True, False, True])
    extra = {"meta": {"arch": "tiny", "step": 7, "lr": 0.25},
             "none": None, "tup": (1, 2.5), "lst": [3, "x"]}
    return ({"params": jp, "ids": jnp.asarray(ids), "mask": jnp.asarray(mask),
             **extra},
            {"params": tp, "ids": torch.from_numpy(ids),
             "mask": torch.from_numpy(mask), **extra})


def _assert_same_leaves(torch_tree, jax_tree):
    got = dict(flatten_with_keystr(torch_tree))
    for path, want in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        t = got[jax.tree_util.keystr(path)]
        want = np.asarray(jax.device_get(want))
        if want.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            assert t.numpy().dtype == want.dtype
            np.testing.assert_array_equal(t.numpy(), want)


def test_checkpoint_crosses_packages_bit_for_bit(tmp_path):
    jtree, ttree = _trees()
    jpath, tpath = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jax_ckpt.save_checkpoint(jpath, jtree, step=7, metadata={"note": "x"})
    checkpoint.save_checkpoint(tpath, ttree, step=7, metadata={"note": "x"})
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    # JAX -> port
    tree, step, meta = checkpoint.load_checkpoint(jpath)
    assert step == 7 and meta == {"note": "x"}
    assert tree["meta"] == jtree["meta"] and tree["tup"] == (1, 2.5)
    assert tree["none"] is None and tree["lst"] == [3, "x"]
    _assert_same_leaves({"params": tree["params"], "ids": tree["ids"],
                         "mask": tree["mask"]},
                        {"params": jtree["params"], "ids": jtree["ids"],
                         "mask": jtree["mask"]})
    # port -> JAX
    jback, jstep, _ = jax_ckpt.load_checkpoint(tpath)
    assert jstep == 7
    _assert_same_leaves(ttree["params"], jback["params"])


def test_bf16_round_trips_bitwise(tmp_path):
    """Subnormals, infinities and NaN payloads survive: the leaf goes
    through an integer view, never a float cast."""
    bits = np.array([0x0001, 0x8001, 0x7f80, 0xff80, 0x7fc1, 0x3f80, 0],
                    np.uint16).view(np.int16)
    x = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    path = str(tmp_path / "c.ckpt")
    checkpoint.save_checkpoint(path, {"x": x})
    loaded, _, _ = checkpoint.load_checkpoint(path)
    assert loaded["x"].dtype == torch.bfloat16
    assert torch.equal(loaded["x"].view(torch.int16), x.view(torch.int16))
    jx, _, _ = jax_ckpt.load_checkpoint(path)
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(jx["x"])).view(np.int16), bits)


def test_checkpoint_atomic_on_failure(tmp_path, monkeypatch):
    path = str(tmp_path / "c.ckpt")
    checkpoint.save_checkpoint(path, {"v": 1}, step=1)

    def boom(src, dst):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint.os, "replace", boom)
    with pytest.raises(OSError):
        checkpoint.save_checkpoint(path, {"v": 2}, step=2)
    monkeypatch.undo()
    tree, step, _ = checkpoint.load_checkpoint(path)
    assert tree["v"] == 1 and step == 1
    assert os.listdir(tmp_path) == ["c.ckpt"]


def test_checkpoint_truncated_and_corrupt(tmp_path):
    path = str(tmp_path / "c.ckpt")
    checkpoint.save_checkpoint(path, {"x": torch.ones(3)}, step=3)
    blob = open(path, "rb").read()
    cases = {"t.ckpt": blob[:len(blob) // 2], "g.ckpt": b"\x00garbage" * 7}
    doc = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    doc["version"] = 2
    cases["v.ckpt"] = msgpack.packb(doc, use_bin_type=True)
    for name, data in cases.items():
        bad = str(tmp_path / name)
        with open(bad, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError):
            checkpoint.load_checkpoint(bad)
