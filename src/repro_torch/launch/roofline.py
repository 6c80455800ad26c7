"""The roofline of one step on H100s, from its ``op_analysis.OpCost``: the
port's counterpart of the JAX package's ``launch/roofline.py``.

Three terms a rank, in seconds (constants in ``launch/mesh.py``):

  compute    = max(FLOPs, MODEL_FLOPS / chips) / PEAK_FLOPS_BF16
  memory     = bytes accessed / HBM_BW
  collective = sum over the step's collectives of wire bytes / the
               bandwidth of that collective's group

Wire bytes follow the ring factors of the JAX module, from a
collective's result bytes ``out`` and group size g:

  all-gather          out x (g-1)/g
  reduce-scatter      out x (g-1)
  all-reduce          out x 2(g-1)/g
  all-to-all          out x (g-1)/g
  collective-permute  out

A group whose ranks lie in one node of ``NODE_GPUS`` consecutive ranks
runs over NVLink, any other over the network; ranks are numbered with
the mesh's last axis ("model") varying fastest.

MODEL_FLOPS (the "useful FLOPs" yardstick) = 6·N_active·tokens for train,
2·N_active·tokens for inference, as in the JAX module.
"""
from __future__ import annotations

import itertools
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.mesh import (HBM_BW, NET_BW, NODE_GPUS, NVLINK_BW,
                                     PEAK_FLOPS_BF16)
from repro_torch.launch.op_analysis import OpCost, wire_bytes
from repro_torch.sharding.rules import mesh_sizes


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    # decode: ONE token per sequence
    return 2.0 * n * shape.global_batch


def in_one_node(sizes: Dict[str, int], axes) -> bool:
    """Whether every group over ``axes`` of a mesh of ``sizes`` (axis
    name to size, the last axis fastest) lies in one node."""
    names = list(sizes)
    strides = {}
    stride = 1
    for name in reversed(names):
        strides[name] = stride
        stride *= sizes[name]
    rest = [n for n in names if n not in axes]
    for fixed in itertools.product(*(range(sizes[n]) for n in rest)):
        base = sum(i * strides[n] for i, n in zip(fixed, rest))
        nodes = {(base + sum(i * strides[a] for i, a in zip(idx, axes)))
                 // NODE_GPUS
                 for idx in itertools.product(*(range(sizes[a])
                                                for a in axes))}
        if len(nodes) > 1:
            return False
    return True


def roofline_terms(cost: OpCost, chips: int, cfg: ModelConfig,
                   shape: InputShape, mesh) -> Dict:
    """The three terms and their inputs for one step on ``mesh`` (a
    ``MeshShape`` or a ``DeviceMesh``), from a rank's ``cost``.

    The compute term takes max(FLOPs, MODEL_FLOPS/chips), as the JAX
    module does: MODEL_FLOPS is a floor that no count may go under."""
    sizes = mesh_sizes(mesh)
    mf = model_flops(cfg, shape)
    t_compute = max(cost.flops, mf / chips) / PEAK_FLOPS_BF16
    t_memory = cost.bytes_accessed / HBM_BW
    bandwidth = {}
    t_coll = 0.0
    for kind, axes, group, nbytes in cost.collectives:
        if axes not in bandwidth:
            bandwidth[axes] = (NVLINK_BW if in_one_node(sizes, axes)
                               else NET_BW)
        t_coll += wire_bytes(kind, nbytes, group) / bandwidth[axes]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    flops_global = cost.flops * chips
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
        "collective_counts": dict(cost.collective_counts),
        "collective_bytes_by_kind": dict(cost.collective_bytes),
        "collective_wire_bytes_per_device": cost.wire_bytes,
        "chips": chips,
    }
