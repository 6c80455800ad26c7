"""Rank-local shards and the collectives between them: what GSPMD does
implicitly for the JAX package, done by hand.

A rank of a ("data", "model") ``DeviceMesh`` holds, of every tensor laid
out by a spec (``sharding/rules.py``), the block that its mesh
coordinates select: a dim whose spec names axes is cut into equal
contiguous blocks, the first axis named being the slowest-varying.
:func:`local_shard` cuts that block from a full tensor; the model
functions then insert the collectives that the layouts imply, through the
thin functions below over the mesh's ``model`` and ``data`` groups. Every
collective is a plain identity when its group has one rank, so a 1x1
mesh computes bit for bit what no mesh computes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.sharding.rules import P, mesh_sizes


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def group_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh_sizes(mesh)[axis]


def _axes(entry) -> Sequence[str]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_block(dim_size: int, entry, mesh) -> slice:
    """The block of a dim of ``dim_size`` that this rank holds under the
    spec ``entry`` (``None``, an axis or a tuple of axes)."""
    parts, index = 1, 0
    for axis in _axes(entry):
        n = group_size(mesh, axis)
        index = index * n + axis_rank(mesh, axis)
        parts *= n
    if dim_size % parts:
        raise ValueError(f"a dim of {dim_size} does not split into {parts} "
                         f"equal blocks")
    size = dim_size // parts
    return slice(index * size, (index + 1) * size)


def local_shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``: a view
    when no dim is cut, else a contiguous copy."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{x.dim()} dims")
    index = tuple(shard_block(x.shape[i], e, mesh)
                  for i, e in enumerate(spec))
    if all(s == slice(0, x.shape[i]) for i, s in enumerate(index)):
        return x
    return x[index].contiguous()


def shard_factor(spec: P, mesh) -> int:
    """How many blocks a tensor laid out by ``spec`` is cut into."""
    n = 1
    for e in spec:
        for axis in _axes(e):
            n *= group_size(mesh, axis)
    return n


def shard_tree(tree, specs, mesh):
    """Each leaf of ``tree`` cut to this rank's block by the matching spec
    of ``specs``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return local_shard(tree, specs, mesh)


# ----------------------------------------------------------------------
# Collectives
# ----------------------------------------------------------------------

def _group(mesh, axis: str):
    return mesh.get_group(axis)


def all_reduce(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s ranks (in place where it can be;
    ``x`` itself when the axis has one rank)."""
    if group_size(mesh, axis) == 1:
        return x
    import torch.distributed as dist
    x = x.contiguous()
    dist.all_reduce(x, group=_group(mesh, axis))
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``axis``'s ranks joined along ``dim`` in rank order
    (``x`` itself when the axis has one rank)."""
    n = group_size(mesh, axis)
    if n == 1:
        return x
    import torch.distributed as dist
    # torch 2.13 renamed all_gather_into_tensor; older releases lack the
    # new name
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    x = x.contiguous()
    # the blocks stacked along dim 0, as the collective writes them
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if x.dtype == torch.bool:  # gloo and NCCL gather bytes, not bools
        gather(out.view(torch.uint8), x.view(torch.uint8),
               group=_group(mesh, axis))
    else:
        gather(out, x, group=_group(mesh, axis))
    if dim % x.dim() == 0:
        return out
    return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=dim)


def gather_rows(x: Optional[torch.Tensor], mesh, dim: int = 0):
    """A pane's rows from every ``data`` rank, joined along ``dim``."""
    return None if x is None else all_gather(x, mesh, "data", dim)


def warm_groups(mesh, device) -> None:
    """One small all-reduce on each mesh axis of more than one rank, so
    that its communicator exists before anything is captured or timed."""
    for axis in mesh.mesh_dim_names:
        if group_size(mesh, axis) > 1:
            all_reduce(torch.zeros(1, device=device), mesh, axis)
