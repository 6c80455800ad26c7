"""``decode_attention``: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors. On meta tensors (the dry run) it checks them as
the CUDA route does and returns an empty output of the kernel's shape,
reporting the plain version's FLOPs to an active analysis
(``_build.on_meta``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16  # query heads per KV head the kernel takes (kMaxGroup)


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"decode_attention: {name} must be a contiguous {dtype} tensor "
            f"of shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def decode_attention(q, k_cache, v_cache, pos, stored):
    """q (B, 1, nq, hd); k/v cache (B, W, nkv, hd); pos (B,) int32; stored
    (B, W) bool. Returns (B, 1, nq, hd).

    Slot j is attendable iff (j <= pos or pos >= W) and stored[j]; see
    ``ref.decode_attention_ref``."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, stored)
    _build.check_no_grad("decode_attention", q, k_cache, v_cache)
    dev = q.device
    b, one, nq, hd = q.shape
    w, nkv = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or q.dtype not in DTYPES or hd not in HEAD_DIMS or nkv == 0 \
            or nq % nkv or nq // nkv > MAX_GROUP or b == 0 or w == 0:
        raise ValueError(f"decode_attention: unsupported q {q.dtype} "
                         f"{tuple(q.shape)} with {nkv} KV heads, W={w}")
    _check("q", q, q.dtype, (b, 1, nq, hd), dev)
    _check("k_cache", k_cache, q.dtype, (b, w, nkv, hd), dev)
    _check("v_cache", v_cache, q.dtype, (b, w, nkv, hd), dev)
    _check("pos", pos, torch.int32, (b,), dev)
    _check("stored", stored, torch.bool, (b, w), dev)
    if dev.type == "meta":
        args = (q, k_cache, v_cache, pos, stored)
        return _build.on_meta("decode_attention", args,
                              (torch.empty_like(q),),
                              lambda: decode_attention_ref(*args))[0]
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention: the kernel reads the K/V cache "
                         "in 16-byte loads; its storage must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    err = _lib()(*[t.data_ptr() for t in (q, k_cache, v_cache, pos, stored,
                                          out)],
                 b, w, nq, nkv, hd, hd ** -0.5,
                 int(q.dtype == torch.bfloat16), dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
