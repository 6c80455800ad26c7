"""Dry run of every (arch x input shape x mesh) on the meta device: the
port's counterpart of the JAX package's ``launch/dryrun.py``.

Each combination builds its step with ``make_step_and_specs(cfg, shape,
MeshShape(...), device="meta")``, a rank's arguments as meta tensors at
their full shapes, and calls it once under ``op_analysis.analyze``:
nothing is allocated and no process group is started; the collectives
and kernels take their abstract routes (``sharding/local.py``, the
kernel wrappers' meta routes). The run gives a rank's memory (its
arguments, and the storages the step holds at once on top of them) and
the roofline's three terms on H100s (``launch/roofline.py``). One JSON a
combination holds the keys that ``benchmarks/run.py::bench_roofline``
reads; ``trace_s`` takes the place of ``lower_s`` and ``compile_s``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k [--multi-pod | --mesh 1,4] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

``--mesh DATA,MODEL`` dry-runs a ("data", "model") mesh of that size,
such as the one or four cards a process group would run, in place of the
pod.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Optional, Tuple

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape, get_shape
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, hbm_bytes
from repro_torch.launch.op_analysis import analyze, storage_bytes
from repro_torch.launch.roofline import roofline_terms
from repro_torch.launch.steps import arch_for_shape, make_step_and_specs
from repro_torch.sharding.rules import MeshShape

DEFAULT_OUT = "experiments/dryrun_torch"


def mesh_for(multi_pod: bool, mesh: Optional[Tuple[int, int]] = None):
    """``(MeshShape, its name in the results)``: the pod, the two pods, or
    a ("data", "model") mesh of ``mesh`` = (data, model)."""
    if mesh is not None:
        if multi_pod:
            raise ValueError("--mesh and --multi-pod exclude each other")
        return (MeshShape(tuple(mesh), ("data", "model")),
                f"mesh_{mesh[0]}x{mesh[1]}")
    if multi_pod:
        return (MeshShape(MULTI_POD, ("pod", "data", "model")),
                "multipod_2x16x16")
    return MeshShape(SINGLE_POD, ("data", "model")), "pod_16x16"


def dry_run(cfg: ModelConfig, shape: InputShape, mesh: MeshShape, *,
            batch: Optional[int] = None) -> dict:
    """The dry run of ``shape``'s step of ``cfg`` on the abstract
    ``mesh``: a rank's memory, whether it fits the card, the roofline
    terms and the largest traffic. ``batch`` replaces the shape's global
    batch."""
    t0 = time.perf_counter()
    step, args, _, _ = make_step_and_specs(cfg, shape, mesh, batch=batch,
                                           device="meta")
    out, cost = analyze(step, args)
    trace_s = time.perf_counter() - t0

    arg_storages = storage_bytes(args)
    argument = sum(arg_storages.values())
    # the outputs that are arguments updated in place (donated)
    alias = sum(n for k, n in storage_bytes(out).items()
                if k in arg_storages)
    peak = argument + cost.peak_bytes
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    chips = math.prod(mesh.sizes)
    return {
        "chips": chips, "batch": shape.global_batch,
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes_per_device": argument,
            "output_bytes_per_device": cost.output_bytes,
            # what the step holds at its peak beyond its new outputs
            "temp_bytes_per_device": max(
                0, cost.peak_bytes - (cost.output_bytes - alias)),
            "alias_bytes_per_device": alias,
            "peak_bytes_per_device": peak,
        },
        "fits": peak <= hbm_bytes(),
        "roofline": roofline_terms(cost, chips, arch_for_shape(cfg, shape),
                                   shape, mesh),
        "top_bytes": cost.top_bytes,
    }


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: str = DEFAULT_OUT,
            mesh: Optional[Tuple[int, int]] = None,
            batch: Optional[int] = None) -> dict:
    """Dry-run one combination (``dry_run``); write its JSON under
    ``out_dir`` and return it."""
    mesh_shape, mesh_name = mesh_for(multi_pod, mesh)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "ok",
              **dry_run(get_config(arch), get_shape(shape_name), mesh_shape,
                        batch=batch)}
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}_{shape_name}_{mesh_name}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def _mesh_arg(text: str) -> Tuple[int, int]:
    data, model = (int(v) for v in text.split(","))
    return data, model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", type=_mesh_arg, default=None,
                    metavar="DATA,MODEL")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from repro_torch.configs.archs import ASSIGNED
    from repro_torch.configs.shapes import SHAPES

    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    failures = 0
    for arch, shape in combos:
        try:
            r = run_one(arch, shape, args.multi_pod, args.out, mesh=args.mesh)
            rt = r["roofline"]
            print(f"OK  {arch:24s} {shape:12s} {r['mesh']:16s} "
                  f"trace={r['trace_s']:6.2f}s "
                  f"peak/dev={r['memory']['peak_bytes_per_device']/2**30:8.2f}"
                  f"GiB terms(c/m/coll)={rt['compute_s']:.2e}/"
                  f"{rt['memory_s']:.2e}/{rt['collective_s']:.2e}s "
                  f"dom={rt['dominant']} fits={r['fits']}")
        except Exception as e:  # one combination's failure, reported
            failures += 1
            print(f"FAIL {arch} {shape}: {type(e).__name__}: {e}")
            traceback.print_exc()
        sys.stdout.flush()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
