"""Weights from the JAX package's parameter tree.

``params_from_numpy`` takes the JAX tree with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's tree: the
same dict paths and the same layouts (``blocks/pos0/attn/wq`` stays
``(R, d, nq, hd)``), as torch tensors. bf16 leaves arrive as numpy's
``bfloat16`` extension dtype and are carried over bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.model import param_shapes


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device="cuda",
                      dtype=None) -> Dict[str, Any]:
    """The port's param tree from a numpy copy of the JAX one, on ``device``,
    cast to ``dtype`` when given. Raises if a path or shape differs from
    ``cfg``'s."""
    device = resolve_device(device)

    def convert(got, want, path):
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got)
            raise ValueError(f"params{path}: {have} != keys {sorted(want)}")
        out = {}
        for k, w in want.items():
            if isinstance(w, dict):
                out[k] = convert(got[k], w, f"{path}/{k}")
                continue
            arr = np.asarray(got[k])
            if arr.shape != w:
                raise ValueError(f"params{path}/{k}: shape {arr.shape} != {w}")
            out[k] = _tensor(arr).to(device=device, dtype=dtype)
        return out

    return convert(tree, param_shapes(cfg), "")
