"""Msgpack checkpoints in the JAX package's format (``training/checkpoint.py``
there), written and read without ``msgpack`` or ``ml_dtypes``.

The tree is a nested msgpack document with tensor leaves stored as
(dtype name, shape, raw little-endian bytes); dicts, lists, tuples, None
and Python scalars keep their own tags. The same leaves give the same
bytes in either package, and each package reads the other's files.
bfloat16 is stored as a uint16 view; numpy has no bf16 without
``ml_dtypes``, so a bf16 leaf decodes to a torch bf16 tensor through an
int16 view. Every other leaf decodes to a CPU tensor of its numpy dtype.
The write is atomic: to a temporary file, then a rename.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.training import _msgpack

_BF16 = "bfloat16"
FORMAT_VERSION = 1


def _encode_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            u16 = x.contiguous().view(torch.int16).numpy().view(np.uint16)
            return {"__nd__": True, "dtype": _BF16, "shape": list(u16.shape),
                    "data": u16.tobytes()}
        x = x.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == _BF16:          # an ml_dtypes array, where present
        u16 = arr.view(np.uint16)
        return {"__nd__": True, "dtype": _BF16, "shape": list(u16.shape),
                "data": u16.tobytes()}
    return {"__nd__": True, "dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _decode_leaf(d: dict) -> torch.Tensor:
    if d["dtype"] == _BF16:
        i16 = np.frombuffer(d["data"], np.int16).reshape(d["shape"])
        return torch.from_numpy(i16.copy()).view(torch.bfloat16)
    arr = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(d["shape"])
    return torch.from_numpy(arr.copy())


def _to_doc(tree):
    """The document of ``tree``. Dict keys go in sorted order: the JAX
    package passes every tree through ``jax.device_get`` first, which
    rebuilds dicts with sorted keys, and the bytes must be the same."""
    if isinstance(tree, dict):
        return {"__map__": {k: _to_doc(tree[k]) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"__seq__": [_to_doc(v) for v in tree],
                "__tuple__": isinstance(tree, tuple)}
    if tree is None:
        return {"__none__": True}
    if isinstance(tree, (int, float, str, bool)):
        return {"__py__": tree}
    return _encode_leaf(tree)


def _from_doc(doc):
    if "__map__" in doc:
        return {k: _from_doc(v) for k, v in doc["__map__"].items()}
    if "__seq__" in doc:
        seq = [_from_doc(v) for v in doc["__seq__"]]
        return tuple(seq) if doc.get("__tuple__") else seq
    if "__none__" in doc:
        return None
    if "__py__" in doc:
        return doc["__py__"]
    return _decode_leaf(doc)


def save_checkpoint(path: str, tree: Any, *, step: int = 0,
                    metadata: dict | None = None) -> None:
    """Write ``tree`` (tensors, numpy arrays, dicts, lists, tuples, None and
    Python scalars) with its ``step`` and ``metadata`` to ``path``,
    atomically."""
    doc = {"version": FORMAT_VERSION, "step": step,
           "metadata": metadata or {}, "tree": _to_doc(tree)}
    payload = _msgpack.packb(doc)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str):
    """``(tree, step, metadata)`` from ``path``; tensor leaves come back as
    CPU tensors. A truncated or corrupt file, or another format version,
    raises ``ValueError``."""
    with open(path, "rb") as f:
        doc = _msgpack.unpackb(f.read())
    if not isinstance(doc, dict) or doc.get("version") != FORMAT_VERSION:
        version = doc.get("version") if isinstance(doc, dict) else None
        raise ValueError(f"{path}: not a version-{FORMAT_VERSION} "
                         f"checkpoint (version {version!r})")
    return _from_doc(doc["tree"]), doc["step"], doc["metadata"]
