"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ``ctypes``.

Every ``kernels/<name>/csrc/<name>.cu`` exports plain C launch functions
(pointers and the stream as ``void*``) that return ``cudaGetLastError()``.
Each source is compiled at first use into ``build/repro_torch/`` at the
root of the checkout, under a name that carries a hash of the source, so an
edited kernel is rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use on a machine with the CUDA toolkit")
    return nvcc


def _source(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _target(name: str) -> Path:
    digest = hashlib.sha1(_source(name).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def kernel_names() -> tuple:
    """Every kernel that has a CUDA source under ``kernels/*/csrc``."""
    return tuple(sorted(p.stem for p in KERNELS_DIR.glob("*/csrc/*.cu")))


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Raises with the compiler's output if
    any of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return _libs[name]


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
