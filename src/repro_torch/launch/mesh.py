"""The serving mesh: a torch ``DeviceMesh`` with axes ("data", "model")
over one process a rank (the JAX package's ``launch/mesh.py``).

JAX runs a mesh from one process; torch runs one process a device, each
issuing the same program (SPMD). :func:`run_on_mesh` starts those
processes, gives each its process group and mesh, and returns rank 0's
result; :func:`make_serving_mesh` builds the mesh inside one of them.
Importing this module touches no device and no process group.

``SINGLE_POD``, ``MULTI_POD`` and :func:`n_chips` are the JAX package's
production mesh shapes, kept as abstract shapes for the sharding rules
and the dry run (``launch/dryrun.py``). The hardware constants below are
the roofline's (``launch/roofline.py``): datasheet figures of one GPU.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import traceback
from datetime import timedelta
from typing import Any, Callable

import torch

from repro_torch.models.common import resolve_device

SINGLE_POD = (16, 16)                # ("data", "model"): 256 ranks
MULTI_POD = (2, 16, 16)              # ("pod", "data", "model"): 512 ranks

# NVIDIA H100 80GB HBM3 (SXM5, 700 W), datasheet figures a GPU
PEAK_FLOPS_BF16 = 989.4e12           # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                     # B/s
NVLINK_BW = 450e9                    # B/s one way, to the node's GPUs
NET_BW = 50e9                        # B/s, one 400 Gb/s NIC a GPU
HBM_BYTES = 80e9                     # B
NODE_GPUS = 8                        # GPUs a node joins over NVLink

# a collective that one rank never joins fails after this long instead of
# hanging its peers
DEFAULT_TIMEOUT_S = 120


def n_chips(multi_pod: bool = False) -> int:
    shape = MULTI_POD if multi_pod else SINGLE_POD
    n = 1
    for s in shape:
        n *= s
    return n


def hbm_bytes() -> float:
    """A rank's device memory: the card's own on a machine with one,
    else the datasheet's ``HBM_BYTES``."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES


def make_serving_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ("data", "model") ``DeviceMesh`` of ``data`` x ``model`` ranks.

    It needs an initialised default process group of exactly
    ``data * model`` ranks (``run_on_mesh`` makes one): NCCL with one card
    a rank on CUDA, gloo on the CPU. A 1x1 mesh with no process group
    gets a one-rank group of its own, so one process can run the sharded
    code path, in which every collective is an identity. Raises
    ``ValueError`` when the ranks or the cards are short, as the JAX
    package's raises when its devices are."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    n = data * model
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(
            f"mesh {data}x{model} needs {n} CUDA devices, have "
            f"{torch.cuda.device_count()}")
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh {data}x{model} needs {n} ranks, have no process "
                f"group; start them with run_on_mesh (launch/serve.py "
                f"--mesh does this for you)")
        _init_group(0, 1, dist.HashStore(), device, DEFAULT_TIMEOUT_S)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"mesh {data}x{model} needs {n} ranks, have {world}; start "
            f"them with run_on_mesh (launch/serve.py --mesh does this for "
            f"you)")
    return init_device_mesh(device.type, (data, model),
                            mesh_dim_names=("data", "model"))


def _init_group(rank: int, world: int, store, device: torch.device,
                timeout_s: float) -> None:
    import torch.distributed as dist

    if device.type == "cuda":
        local = torch.device("cuda", rank)
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=world, device_id=local,
                                timeout=timedelta(seconds=timeout_s))
    else:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s))


def close_mesh() -> None:
    """Destroy this process's default process group, if it has one."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _host(tree):
    """Tensors in a result tree as numpy arrays (bf16 as float32), so the
    result crosses the process boundary by value."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_host(v) for v in tree)
    return tree


def _worker(rank: int, data: int, model: int, store_path: str,
            device_type: str, timeout_s: float, fn: Callable, args,
            results) -> None:
    import torch.distributed as dist

    try:
        # the ranks share the host: each takes its share of the cores for
        # its intra-op threads (one on the CPU, where the ranks compute),
        # so that no rank's threads spin on another's cores
        world = data * model
        torch.set_num_threads(1 if device_type == "cpu" else
                              max(1, (os.cpu_count() or 1) // world))
        device = torch.device(device_type)
        store = dist.FileStore(store_path, data * model)
        _init_group(rank, data * model, store, device, timeout_s)
        try:
            mesh = make_serving_mesh(data, model, device_type)
            out = fn(mesh, *args)
            results.put((rank, "ok", _host(out) if rank == 0 else None))
        finally:
            close_mesh()
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_on_mesh(data: int, model: int, fn: Callable, *args,
                device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """Run ``fn(mesh, *args)`` on a ``data`` x ``model`` mesh, one spawned
    process a rank, and return rank 0's result (its tensors as numpy
    arrays). ``fn`` and ``args`` are pickled: ``fn`` must be a module-level
    function of an importable module.

    The ranks meet through a ``FileStore`` in a new temporary directory,
    so concurrent meshes never collide. On CUDA rank ``i`` takes card
    ``i``, the group is NCCL and each rank runs its share of the host's
    cores as intra-op threads; on the CPU the group is gloo and each rank
    runs one. A collective that a rank never joins
    fails after ``timeout_s``. Raises ``RuntimeError`` with the rank's
    traceback if any rank fails."""
    import multiprocessing
    import queue

    device = resolve_device(device)
    n = data * model
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(
            f"mesh {data}x{model} needs {n} CUDA devices, have "
            f"{torch.cuda.device_count()}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="mesh-")
    procs = [ctx.Process(target=_worker, daemon=True, args=(
        rank, data, model, os.path.join(tmp, "store"), device.type,
        timeout_s, fn, args, results)) for rank in range(n)]
    try:
        for p in procs:
            p.start()
        got, errors = {}, []
        while len(got) + len(errors) < n:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead and not errors:
                    raise RuntimeError(
                        f"mesh {data}x{model}: rank {dead[0]} exited with "
                        f"code {procs[dead[0]].exitcode} and no result")
                continue
            if status == "ok":
                got[rank] = value
            else:
                errors.append((rank, value))
                break
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"mesh {data}x{model}: rank {rank} failed:\n"
                               f"{tb}")
        for p in procs:
            p.join()
        return got[0]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
