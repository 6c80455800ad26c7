"""Weights from the JAX package's parameter tree.

``params_from_numpy`` takes the JAX tree with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's tree: the
same dict paths and the same layouts (``blocks/pos0/attn/wq`` stays
``(R, d, nq, hd)``), as torch tensors. bf16 leaves arrive as numpy's
``bfloat16`` extension dtype and are carried over bit for bit. A cast to
``dtype`` gives each leaf the type ``init_params(cfg, dtype=dtype)`` gives
it: the SSM's ``A_log``, ``D`` and ``dt_bias`` stay f32 in a bf16 model.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.model import init_params
from repro_torch.sharding.local import local_shard


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


# the types JAX gives numpy's 64-bit arrays with x64 off (its default)
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32,
              np.dtype(np.complex128): np.complex64}


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is, or a new CPU tensor from anything numpy takes,
    its dtype as ``jnp.asarray`` would give it (64-bit types narrowed to
    32, ml_dtypes' bf16 kept bit for bit)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype in _CANONICAL:
        arr = arr.astype(_CANONICAL[arr.dtype])
    return _tensor(arr)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device="cuda",
                      dtype=None, mesh=None, specs=None) -> Dict[str, Any]:
    """The port's param tree from a numpy copy of the JAX one, on ``device``,
    cast when ``dtype`` is given to the leaf types of a ``dtype`` model.
    Raises if a path or shape differs from ``cfg``'s. With a ``mesh`` each
    leaf is cut to this rank's block of the serving layout, or of the
    layout of ``specs`` when given (``param_pspecs(cfg, mesh)`` for
    training), on the host, before it moves, so no device ever holds a
    whole sharded leaf."""
    device = resolve_device(device)
    if mesh is None:
        specs = None
    elif specs is None:
        from repro_torch.sharding.rules import serving_param_pspecs
        specs = serving_param_pspecs(cfg, mesh)

    def convert(got, want, path, spec):
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got)
            raise ValueError(f"params{path}: {have} != keys {sorted(want)}")
        out = {}
        for k, w in want.items():
            sub = None if spec is None else spec[k]
            if isinstance(w, dict):
                out[k] = convert(got[k], w, f"{path}/{k}", sub)
                continue
            arr = np.asarray(got[k])
            if arr.shape != w.shape:
                raise ValueError(
                    f"params{path}/{k}: shape {arr.shape} != {tuple(w.shape)}")
            t = _tensor(arr)
            if sub is not None:
                t = local_shard(t, sub, mesh)
            out[k] = t.to(device=device,
                          dtype=None if dtype is None else w.dtype)
        return out

    like = init_params(cfg, torch.Generator(), dtype or torch.float32, "meta")
    return convert(tree, like, "", specs)
