"""``flash_attention``: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"flash_attention: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def flash_attention(q, k, v, qpos, kpos, kvalid, *, window: int = 0):
    """q (B, Sq, nq, hd); k/v (B, Sk, nkv, hd); qpos (B, Sq) int32; kpos
    (B, Sk) int32; kvalid (B, Sk) bool. Returns (B, Sq, nq, hd).

    Query i attends key j iff qpos[i] >= kpos[j], qpos[i] - kpos[j] <
    window (when window > 0) and kvalid[j]; see ``ref.attention_ref``."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, qpos, kpos, kvalid, window=window)
    dev = q.device
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES or hd not in HEAD_DIMS or nkv == 0 \
            or nq % nkv or b == 0 or sq == 0 or sk == 0:
        raise ValueError(f"flash_attention: unsupported q {q.dtype} "
                         f"{tuple(q.shape)} with {nkv} KV heads, Sk={sk}")
    _check("q", q, q.dtype, (b, sq, nq, hd), dev)
    _check("k", k, q.dtype, (b, sk, nkv, hd), dev)
    _check("v", v, q.dtype, (b, sk, nkv, hd), dev)
    _check("qpos", qpos, torch.int32, (b, sq), dev)
    _check("kpos", kpos, torch.int32, (b, sk), dev)
    _check("kvalid", kvalid, torch.bool, (b, sk), dev)
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # 16-byte copies
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    err = _lib()(*[t.data_ptr() for t in (q, k, v, qpos, kpos, kvalid, out)],
                 b, sq, sk, nq, nkv, hd, window, hd ** -0.5,
                 int(q.dtype == torch.bfloat16), dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
