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

An axis argument is one axis name or a tuple of them (a group over
their product, the first slowest, as a spec entry cuts a dim):
:func:`dp_axes` names the data axes, ``("pod", "data")`` on a multi-pod
mesh. A torch ``DeviceMesh`` runs a group of one axis.

The abstract route. The mesh may also be an abstract ``MeshShape`` when
the tensors are on the meta device (the dry run, ``launch/dryrun.py``).
A rank's coordinates are then rank 0's (every rank's blocks have one
shape), and each collective allocates what the real one does and returns
a meta tensor of its result's shape, with nothing sent. A collective
given a ``MeshShape`` and a tensor that is not on meta raises.

Every collective call, on either kind of mesh, reports ``(kind, axes,
group size, result)`` to an active ``launch/op_analysis.py`` analysis
(none is active outside one, and then nothing is recorded).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.launch.op_analysis import record_collective
from repro_torch.sharding.rules import MeshShape, P, data_axes, mesh_sizes


def _axes(entry) -> Sequence[str]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dp_axes(mesh):
    """The data axes as one axis argument: "data" (also without a mesh),
    or ("pod", "data") on a multi-pod mesh."""
    axes = data_axes(mesh) if mesh is not None else ("data",)
    return axes[0] if len(axes) == 1 else axes


def axis_rank(mesh, axis) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh, and on an
    abstract one: rank 0's)."""
    if mesh is None or isinstance(mesh, MeshShape):
        return 0
    index = 0
    for a in _axes(axis):
        index = index * group_size(mesh, a) + int(mesh.get_local_rank(a))
    return index


def group_size(mesh, axis) -> int:
    """The size of ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    sizes = mesh_sizes(mesh)
    n = 1
    for a in _axes(axis):
        n *= sizes[a]
    return n


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
    when no dim is cut, else a contiguous copy of its own (a block of
    rows is already contiguous, but as a view it would keep the whole
    tensor's storage alive)."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{x.dim()} dims")
    index = tuple(shard_block(x.shape[i], e, mesh)
                  for i, e in enumerate(spec))
    if all(s == slice(0, x.shape[i]) for i, s in enumerate(index)):
        return x
    return x[index].clone(memory_format=torch.contiguous_format)


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

def _group(mesh, axis):
    axes = _axes(axis)
    if len(axes) != 1:
        raise ValueError(f"a DeviceMesh runs a group of one axis, not "
                         f"{axes}")
    return mesh.get_group(axes[0])


def _abstract(mesh, x: torch.Tensor) -> bool:
    """Whether a collective on ``x`` is only shapes: an abstract mesh,
    whose tensors must be on meta."""
    if not isinstance(mesh, MeshShape):
        return False
    if x.device.type != "meta":
        raise ValueError(f"an abstract MeshShape runs meta tensors only; "
                         f"got one on {x.device}")
    return True


def all_reduce(x: torch.Tensor, mesh, axis="model") -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s ranks (in place where it can be;
    ``x`` itself when the axis has one rank)."""
    n = group_size(mesh, axis)
    if n == 1:
        return x
    x = x.contiguous()
    record_collective("all-reduce", axis, n, x)
    if not _abstract(mesh, x):
        import torch.distributed as dist
        dist.all_reduce(x, group=_group(mesh, axis))
    return x


def all_gather(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """The blocks of ``axis``'s ranks joined along ``dim`` in rank order
    (``x`` itself when the axis has one rank)."""
    n = group_size(mesh, axis)
    if n == 1:
        return x
    x = x.contiguous()
    # the blocks stacked along dim 0, as the collective writes them
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    record_collective("all-gather", axis, n, out)
    if not _abstract(mesh, x):
        import torch.distributed as dist
        # torch 2.13 renamed all_gather_into_tensor; older releases lack
        # the new name
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        if x.dtype == torch.bool:  # gloo and NCCL gather bytes, not bools
            gather(out.view(torch.uint8), x.view(torch.uint8),
                   group=_group(mesh, axis))
        else:
            gather(out, x, group=_group(mesh, axis))
    if dim % x.dim() == 0:
        return out
    return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=dim)


def gather_rows(x: Optional[torch.Tensor], mesh, dim: int = 0):
    """A pane's rows from every data rank, joined along ``dim``."""
    return None if x is None else all_gather(x, mesh, dp_axes(mesh), dim)


def warm_groups(mesh, device) -> None:
    """One small all-reduce on each mesh axis of more than one rank, so
    that its communicator exists before anything is captured or timed."""
    for axis in mesh.mesh_dim_names:
        if group_size(mesh, axis) > 1:
            all_reduce(torch.zeros(1, device=device), mesh, axis)


# ----------------------------------------------------------------------
# Collectives with gradients: the training layout
# ----------------------------------------------------------------------
#
# A rank of a region cut over an axis computes a part of that region's
# work; a tensor that every rank holds alike then has, on each rank, a
# gradient that is its part of the whole (the whole is their sum). The
# functions below give each collective its conjugate so that, on any
# mesh, the gradient a rank finds for each of its shards is that shard's
# block of the one-device gradient. Each is the plain collective above
# when no gradient is asked for (the serving path), and the identity on
# an axis of one rank.

def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _summed(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ``axis``'s ranks."""
    out = x.clone(memory_format=torch.contiguous_format)
    record_collective("all-reduce", axis, group_size(mesh, axis), out)
    if not _abstract(mesh, x):
        import torch.distributed as dist
        dist.all_reduce(out, group=_group(mesh, axis))
    return out


def _block(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axis``."""
    blk = shard_block(x.shape[dim], axis, mesh)
    return x.narrow(dim, blk.start, blk.stop - blk.start)


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh, ctx.axis), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _summed(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def _reduce_scatter(g: torch.Tensor, mesh, axis, dim: int):
    """The sum of ``g`` over ``axis``'s ranks, this rank's block along
    ``dim``."""
    n = group_size(mesh, axis)
    front = g.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // n,) + tuple(front.shape[1:]),
                      dtype=g.dtype, device=g.device)
    record_collective("reduce-scatter", axis, n, out)
    if not _abstract(mesh, g):
        import torch.distributed as dist
        # torch 2.13 renamed reduce_scatter_tensor, as all_gather's
        # collective
        scatter = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        scatter(out, front, group=_group(mesh, axis))
    return out.movedim(0, dim)


class _GatherPart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


def grad_sum(x: torch.Tensor, mesh, axis="model") -> torch.Tensor:
    """``x`` itself, its gradient summed over ``axis``: where a tensor
    that every rank holds alike enters a region cut over ``axis`` (the
    entry of a column-cut matmul), or a replicated weight is used inside
    one."""
    if mesh is None or group_size(mesh, axis) == 1 or not _needs_grad(x):
        return x
    return _GradSum.apply(x, mesh, axis)


def reduce_sum(x: torch.Tensor, mesh, axis="model") -> torch.Tensor:
    """The sum of ``x`` over ``axis``, its gradient passed on unchanged:
    the exit of a cut region into one that every rank computes alike. In
    place where it can be when no gradient is asked for, as
    :func:`all_reduce`."""
    if mesh is None or group_size(mesh, axis) == 1:
        return x
    if not _needs_grad(x):
        return all_reduce(x, mesh, axis)
    return _Sum.apply(x, mesh, axis)


def gather_whole(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """:func:`all_gather`, whose backward keeps this rank's block of the
    gradient: for a result that every rank then uses alike (the vocab-cut
    logits before the loss, a d-cut embedding)."""
    if mesh is None or group_size(mesh, axis) == 1:
        return x
    if not _needs_grad(x):
        return all_gather(x, mesh, axis, dim)
    return _Gather.apply(x, mesh, axis, dim)


def gather_part(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """:func:`all_gather`, whose backward sums the gradient over ``axis``
    and keeps this rank's block of the sum (a reduce-scatter): for a
    result that each rank then uses for its own part (q gathered to every
    head_dim column, a weight's FSDP blocks)."""
    if mesh is None or group_size(mesh, axis) == 1:
        return x
    if not _needs_grad(x):
        return all_gather(x, mesh, axis, dim)
    return _GatherPart.apply(x, mesh, axis, dim)


def fsdp_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """A weight's FSDP blocks all-gathered over the data axes along
    ``dim``; its gradient reduce-scattered (summed) back to this rank's
    block."""
    return gather_part(x, mesh, dp_axes(mesh), dim)


def fsdp_tree(tree, specs, mesh):
    """Each leaf of ``tree`` gathered over the data axes on the dim its
    spec cuts over them (:func:`fsdp_gather`); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: fsdp_tree(v, specs[k], mesh) for k, v in tree.items()}
    for dim, entry in enumerate(specs):
        if "data" in _axes(entry):
            return fsdp_gather(tree, mesh, dim)
    return tree


def cuts(spec: P, axis) -> bool:
    """Whether ``spec`` cuts a dim over ``axis`` (any of them, for a
    tuple of axes)."""
    return any(a in _axes(e) for e in spec for a in _axes(axis))


def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape of a rank's block of a tensor of ``shape`` under
    ``spec`` (for any mesh, an abstract one included)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        parts = 1
        for axis in _axes(entry):
            parts *= mesh_sizes(mesh)[axis]
        if out[dim] % parts:
            raise ValueError(f"a dim of {out[dim]} does not split into "
                             f"{parts} equal blocks")
        out[dim] //= parts
    return tuple(out)
