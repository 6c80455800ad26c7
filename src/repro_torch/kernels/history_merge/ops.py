"""``history_merge``: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor. On meta tensors (the dry run) it checks them as the
CUDA route does and returns empty outputs of the kernel's shapes,
reporting its traffic to an active analysis (``_build.on_meta``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.history_merge.ref import history_merge_ref

# events a row may hold: the kernel keeps a row's hash table, sort keys and
# items in shared memory (172 KB at 3072 events) and stages up to four
# events a thread, 1024 threads a row
MAX_EVENTS = 3072


def _lib():
    lib = _build.load("history_merge")
    fn = lib.history_merge_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def history_merge(batch_items, batch_ts, batch_valid, rt_items, rt_ts,
                  rt_valid, *, out_len: int):
    """Inputs (B, L_batch) / (B, L_rt) int32 tensors on one device. Returns
    (items, ts, valid), each (B, out_len) int32 on that device."""
    args = (batch_items, batch_ts, batch_valid, rt_items, rt_ts, rt_valid)
    if batch_items.device.type == "cpu":
        return history_merge_ref(*args, out_len=out_len)
    dev = batch_items.device
    b, lb = batch_items.shape
    lr = rt_items.shape[1]
    for a, width in zip(args, (lb,) * 3 + (lr,) * 3):
        if a.device != dev or a.dtype != torch.int32 \
                or a.shape != (b, width) or not a.is_contiguous():
            raise ValueError(
                "history_merge: inputs must be contiguous int32 tensors of "
                f"shape ({b}, L) on {dev}; got {a.dtype} {tuple(a.shape)} "
                f"on {a.device}")
    if b == 0 or out_len <= 0 or lb + lr > MAX_EVENTS:
        raise ValueError(f"history_merge: unsupported shape B={b}, "
                         f"N={lb + lr}, K={out_len}")
    outs = [torch.empty((b, out_len), dtype=torch.int32, device=dev)
            for _ in range(3)]
    if dev.type == "meta":
        return _build.on_meta(
            "history_merge", args, tuple(outs),
            lambda: history_merge_ref(*args, out_len=out_len))
    err = _lib()(*[t.data_ptr() for t in (*args, *outs)], b, lb, lr, out_len,
                 dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "history_merge")
    history_merge.launches += 1
    return tuple(outs)


history_merge.launches = 0
