"""``ssd_scan``: the CUDA kernel for CUDA tensors, the plain version
(``ref.ssd_chunked``) for CPU tensors. On meta tensors (the dry run) it
checks them as the CUDA route does and returns empty outputs of the
kernel's shapes, reporting the plain version's FLOPs to an active
analysis (``_build.on_meta``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

HEAD_DIMS = (32, 64, 128)    # hp the kernel is built for
STATE_DIMS = (32, 64, 128)   # ds
MAX_CHUNK = 256              # kMaxChunk
DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"ssd_scan: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256, init_state=None):
    """The SSD scan with the JAX package's ``ssd_scan`` contract.

    x (b,s,nh,hp); dt (b,s,nh) f32, post-softplus; A (nh,) f32, negative;
    B, C (b,s,ds) in x's dtype; D (nh,) f32; init_state (b,nh,hp,ds) f32
    or None (zeros, not read). ``chunk`` is cut to ``min(chunk, s)`` and
    must divide s. Returns (y (b,s,nh,hp) in x.dtype, h_final f32)."""
    b, s, nh, hp = x.shape
    chunk = min(chunk, s)
    if chunk <= 0 or s % chunk:
        raise ValueError(f"ssd_scan: seq {s} not divisible by chunk {chunk}")
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                           init_state=init_state)
    _build.check_no_grad("ssd_scan", x, dt, A, B, C, D, init_state)
    dev = x.device
    ds = B.shape[-1]
    if x.dtype not in DTYPES or hp not in HEAD_DIMS or ds not in STATE_DIMS \
            or chunk > MAX_CHUNK or b == 0:
        raise ValueError(f"ssd_scan: unsupported x {x.dtype} {tuple(x.shape)}"
                         f" with d_state {ds} and chunk {chunk}")
    _check("x", x, x.dtype, (b, s, nh, hp), dev)
    _check("dt", dt, torch.float32, (b, s, nh), dev)
    _check("A", A, torch.float32, (nh,), dev)
    _check("B", B, x.dtype, (b, s, ds), dev)
    _check("C", C, x.dtype, (b, s, ds), dev)
    _check("D", D, torch.float32, (nh,), dev)
    if init_state is not None:
        _check("init_state", init_state, torch.float32, (b, nh, hp, ds), dev)
    y = torch.empty_like(x)
    h_final = torch.empty((b, nh, hp, ds), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        args = (x, dt, A, B, C, D)
        return _build.on_meta(
            "ssd_scan", args + (init_state,), (y, h_final),
            lambda: ssd_chunked(*args, chunk=chunk, init_state=init_state))
    err = _lib()(*[t.data_ptr() for t in (x, dt, A, B, C, D)],
                 None if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), h_final.data_ptr(), b, s, nh, hp, ds, chunk,
                 int(x.dtype == torch.bfloat16), dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0
