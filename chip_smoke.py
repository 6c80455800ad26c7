#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``src/repro_torch``) on one GPU and checks it.

    python3 chip_smoke.py

1. builds every CUDA kernel of the port from ``src/repro_torch/**/csrc/*.cu``
   (one ``nvcc`` per source, all started together);
2. holds ``history_merge`` bit for bit against its plain PyTorch version,
   at the serving design point and on adversarial rows;
3. holds ``flash_attention`` against its plain version at the ranker's
   shapes, in bf16 and fp32, and times it beside SDPA and a bound that
   counts only the bytes and products these inputs need; it is timed
   again at the feature path's and the token path's own inputs;
4. drives the feature-level injection path, ``RecommenderPlatform.serve``
   with policy "inject", at the full width of the registered
   ``itfi-ranker`` over a 100k-user / 3.2M-event feature plane, counting
   kernel launches, then compares the kernel path with the plain path at
   fp32 on the same card;
5. times each kernel, its plain version and a PyTorch library call with
   CUDA events, and the path in requests/s;
6. holds ``decode_attention`` against its plain version in bf16 and fp32,
   at the serving shape and at a GQA shape;
7. drives the token-level path, ``ServingEngine.prefill`` -> ``inject`` ->
   ``decode_slate``, at the same width over the same feature plane (4
   panes of 256 users), counting kernel launches, then compares its kernel
   path with its plain path at fp32, teacher-forced over every decode
   step, and times the phases, the kernels at the path's own inputs and
   one profiled pane;
8. holds ``ssd_scan`` against its plain version in bf16 and fp32 at the
   prefill and inject shapes of the registered ``mamba2-780m``, with
   padded rows and a random initial state, and at its prefill shape with
   every position live, and checks that bad inputs raise;
9. drives the Mamba2 token path, the same three phases on ``mamba2-780m``
   at full width (48 SSM layers, bf16 weights from a seed) in 4 panes of
   64 users from the same feature plane, counting ``ssd_scan`` launches
   (48 in prefill and 48 in inject a pane), then times the kernel at the
   path's own inputs and at a fully live prefill, and one profiled pane, and compares the kernel path
   with the plain path at fp32 on a pane of 16 rows (prefill, inject and
   every teacher-forced decode step's logits within 1e-4, equal slates).

It needs a CUDA device: without one it exits non-zero and prints no result.
The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
DAY = 86400
N_USERS, N_EVENTS = 100_000, 3_200_000      # the feature-plane scale
N_FRESH = 400_000                            # events after the snapshot
FEATURE_LEN, BUFFER_LEN = 256, 64
SERVE_BATCH, N_BATCHES = 256, 8
PANE_PREFILL, PANE_INJECT, PANE_CAPACITY = 256, 64, 384  # token path
N_PANES, SLATE_LEN = 4, 10
# the Mamba2 path's panes: 64 rows, as each row's f32 SSM state is 48 x 48
# x 64 x 128 x 4 B = 75.5 MB; the fp32 comparison on a smaller pane
MAMBA_BATCH, MAMBA_FP32_ROWS = 64, 16
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int32": 67e12}
TOL = {"bfloat16": 3e-2, "float32": 2e-5}    # as tests/test_kernels.py
E2E_TOL = 1e-4


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0.0)


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms per call, {kernel name: device ms per call}) of ``fn()``:
    the summed durations of the kernels it launches, from a profiler trace,
    without the host's launch overhead or the gaps between kernels. A trace
    that holds no device time at all (the profiler now and then returns
    one) is taken again, up to three times; after that the time comes from
    CUDA events (launch gaps included) and no kernel is named."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per_kernel = {e.key: _device_us(e) / 1e3 / iters
                      for e in prof.key_averages() if _device_us(e) > 0}
        total = sum(per_kernel.values())
        if total > 0:
            return total, per_kernel
        print(f"the profiler recorded no device time (trace {attempt + 1} "
              f"of 3)")
    ms = time_ms(fn, iters, warmup=0)
    print(f"device time from CUDA events instead: {ms:.4f} ms a call")
    return ms, {}


def bound(n_bytes: float, n_ops: float, kind: str):
    """(bound_ms, bound_by): the larger of the bytes over HBM rate and the
    operations over the peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# history_merge
# ----------------------------------------------------------------------

def merge_inputs(rng, b, lb, lr, n_items, t_max, dev):
    import torch
    arrs = [rng.randint(0, n_items, (b, lb)), rng.randint(0, t_max, (b, lb)),
            rng.rand(b, lb) < 0.9, rng.randint(0, n_items, (b, lr)),
            rng.randint(t_max // 2, t_max, (b, lr)), rng.rand(b, lr) < 0.9]
    return [torch.from_numpy(np.asarray(a, np.int32)).to(dev) for a in arrs]


def adversarial_merge_inputs(rng, dev):
    """Rows shaped after tests/test_history_merge_adversarial.py: dead
    sides, timestamp-tie storms, duplicated item sets, item 0."""
    import torch
    b, lb, lr = 40, 16, 8
    bi, bt = rng.randint(0, 9, (b, lb)), rng.randint(0, 100, (b, lb))
    ri, rt = rng.randint(0, 9, (b, lr)), rng.randint(0, 100, (b, lr))
    bv, rv = np.ones((b, lb)), np.ones((b, lr))
    bv[0:3], rv[3:6], bv[6:9], rv[6:9] = 0, 0, 0, 0      # dead sides
    bt[10:18], rt[10:18] = 777, 777                       # tie storms
    ri[18:26], rt[18:26] = bi[18:26, :lr], bt[18:26, :lr] + 1  # same items
    bi[18:26, lr:] = bi[18:26, :lb - lr]                  # in-buffer dups
    bi[26:34, ::2], ri[26:34, ::3] = 0, 0                 # item 0
    arrs = (bi, bt, bv, ri, rt, rv)
    return [torch.from_numpy(np.asarray(a, np.int32)).to(dev) for a in arrs]


def check_history_merge(dev, report, gpu):
    import torch
    from repro_torch.kernels.history_merge.ops import history_merge
    from repro_torch.kernels.history_merge.ref import history_merge_ref

    rng = np.random.RandomState(SEED)
    b, lb, lr, k = SERVE_BATCH, FEATURE_LEN, BUFFER_LEN, FEATURE_LEN
    design = merge_inputs(rng, b, lb, lr, 4864, 10**6, dev)
    cases = [("design point", design, k),
             ("adversarial", adversarial_merge_inputs(rng, dev), 12)]
    for name, (lb_, lr_) in (("empty realtime side", (16, 0)),
                             ("empty batch side", (0, 8)),
                             ("both sides empty", (0, 0))):
        cases.append((name, merge_inputs(rng, 8, lb_, lr_, 9, 50, dev), 6))
    cases.append(("N = 3000",  # near the most events the kernel takes
                  merge_inputs(rng, 16, 2000, 1000, 200, 10**4, dev), 512))
    extremes = merge_inputs(rng, 16, 40, 12, 12, 2, dev)
    ends = np.array([np.iinfo(np.int32).min, -1, 0, np.iinfo(np.int32).max],
                    np.int32)
    for i, width in ((1, 40), (4, 12)):  # ts at int32's ends and around 0
        extremes[i] = torch.from_numpy(
            ends[rng.randint(0, 4, (16, width))]).to(dev)
    cases.append(("int32 extremes of ts", extremes, 24))
    err = 0
    for name, args, out_len in cases:
        got = history_merge(*args, out_len=out_len)
        want = history_merge_ref(*args, out_len=out_len)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise SystemExit(f"history_merge differs from its plain "
                                 f"version on the {name} rows")
            err = max(err, int((g - w).abs().max()) if g.numel() else 0)
        print(f"history_merge {name}: bit-equal to the plain version "
              f"(B={args[0].shape[0]}, Lb={args[0].shape[1]}, "
              f"Lr={args[3].shape[1]}, K={out_len})")

    call_ms = time_ms(lambda: history_merge(*design, out_len=k))
    ms, _ = device_ms(lambda: history_merge(*design, out_len=k))
    plain_ms, _ = device_ms(lambda: history_merge_ref(*design, out_len=k), 5, 1)
    n = lb + lr
    n_bytes = 4 * 3 * b * (lb + lr + k)
    n_ops = b * n * math.log2(n)  # a comparison sort's least work per row
    bound_ms, bound_by = bound(n_bytes, n_ops, "int32")
    print(f"time history_merge B={b} N={n} K={k}: kernel {ms:.4f} ms on the "
          f"device ({call_ms:.4f} ms per wrapper call, CUDA events), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) [{gpu}]")
    report["history_merge"] = dict(
        name="history_merge", route="cuda",
        source="src/repro_torch/kernels/history_merge/csrc/history_merge.cu",
        replaces="src/repro/kernels/history_merge/history_merge.py:68",
        max_abs_err=float(err), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)


# ----------------------------------------------------------------------
# flash_attention
# ----------------------------------------------------------------------

def attention_inputs(dev, dtype, b=SERVE_BATCH, s=FEATURE_LEN, heads=8,
                     hd=32):
    """The ranker's attention shapes: left-padded key validity with
    history lengths spread over [0, S], one row with no valid key."""
    import torch
    g = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn((b, s, heads, hd), generator=g).to(dev, dtype)
               for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    lengths = torch.randint(0, s + 1, (b,), generator=g).to(dev)
    lengths[0] = 0
    kvalid = pos >= (s - lengths)[:, None]
    return q, k, v, pos.contiguous(), pos.contiguous(), kvalid.contiguous()


def attention_work(args, window=0):
    """Bytes moved and operations needed for these inputs, counting only
    what the result depends on: Q of the query rows with a live key, K of
    the valid keys, V of the valid keys (all Sk keys of a batch row where
    some query row has no live key, as that row gets the mean of V), O
    whole, the positions and the key mask once; 4*hd products per live
    (query, key) pair and head, and hd adds per key and KV head for the V
    mean of a batch row with a dead query row."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_mask
    q, k, _, qpos, kpos, kvalid = args
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    item = q.element_size()
    mask = attention_mask(qpos, kpos, kvalid, window)
    live_rows = mask.any(-1)                          # (B, Sq)
    dead_b = (~live_rows).any(-1)                     # (B,)
    n_valid = kvalid.sum(-1)                          # (B,)
    v_keys = float(torch.where(dead_b, torch.full_like(n_valid, sk),
                               n_valid).sum())
    row = hd * item
    n_bytes = (float(live_rows.sum()) * nq + float(n_valid.sum()) * nkv
               + v_keys * nkv + b * sq * nq) * row \
        + 4 * b * (sq + sk) + b * sk
    n_ops = 4 * hd * nq * float(mask.sum()) \
        + hd * sk * nkv * float(dead_b.sum())
    return n_bytes, n_ops, float(live_rows.float().mean())


def time_flash(args, kwargs, label, gpu):
    """The kernel, its plain version and SDPA (one PyTorch call with the
    mask as a bias) on the same inputs; returns the measured times and
    the bound of these inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                         attention_mask,
                                                         attention_ref)
    q, k, v, qpos, kpos, kvalid = args
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    window = kwargs.get("window", 0)
    kind = str(q.dtype).split(".")[1]
    call_ms = time_ms(lambda: flash_attention(*args, **kwargs))
    ms, _ = device_ms(lambda: flash_attention(*args, **kwargs))
    plain_ms, _ = device_ms(lambda: attention_ref(*args, **kwargs), 5, 1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bias = torch.where(attention_mask(qpos, kpos, kvalid, window), 0.0,
                       NEG_INF).to(q.dtype)[:, None]
    gqa = {"enable_gqa": True} if nq != nkv else {}
    library_ms, lib_kernels = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias,
                                               **gqa))
    n_bytes, n_ops, live = attention_work(args, window)
    bound_ms, bound_by = bound(n_bytes, n_ops, kind)
    print(f"time flash_attention {kind} at the {label} (B={b}, Sq={sq}, "
          f"Sk={sk}, {nq}/{nkv} heads of {hd}, {live:.3f} of query rows "
          f"live): kernel {ms:.4f} ms on the device ({call_ms:.4f} ms per "
          f"wrapper call, CUDA events), plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms ({', '.join(x[:40] for x in lib_kernels)}), "
          f"kernel/sdpa {ms / library_ms:.3f}, bound {bound_ms:.4f} ms "
          f"({bound_by}; {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP), "
          f"kernel/bound {ms / bound_ms:.2f} [{gpu}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_flash_attention(dev, report, gpu):
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    for dtype in (torch.bfloat16, torch.float32):
        kind = str(dtype).split(".")[1]
        args = attention_inputs(dev, dtype)
        got = flash_attention(*args)
        want = attention_ref(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.isfinite(got).all():
            raise SystemExit(f"flash_attention {kind}: non-finite output")
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[kind],
                                   rtol=TOL[kind])
        print(f"flash_attention {kind} (B, S, heads, hd)="
              f"{tuple(args[0].shape)}: max abs err {err:.3g} vs the plain "
              f"version (tolerance {TOL[kind]})")
        times = time_flash(args, {}, "prefill shape, synthetic inputs", gpu)
        if dtype == torch.bfloat16:  # the main path's dtype
            report["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/"
                         "flash_attention.py:93",
                max_abs_err=err, **times)


def time_flash_at(prefix, args, kwargs, label, report, gpu):
    """``time_flash`` at one of a path's own flash_attention calls, its
    numbers added to the report under ``prefix``."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    got = flash_attention(*args, **kwargs)
    want = attention_ref(*args, **kwargs)
    torch.cuda.synchronize()
    kind = str(args[0].dtype).split(".")[1]
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[kind],
                               rtol=TOL[kind])
    print(f"flash_attention {kind} at the {label}: max abs err {err:.3g} vs "
          f"the plain version (tolerance {TOL[kind]})")
    times = dict(time_flash(args, kwargs, label, gpu), max_abs_err=err)
    report["flash_attention"].update(
        {f"{prefix}_{k}": v for k, v in times.items()})


# ----------------------------------------------------------------------
# The main path, end to end
# ----------------------------------------------------------------------

def build_platform(dev, params, cfg):
    from repro_torch.core import (BatchFeatureStore, FeatureInjector,
                                  FeatureStoreConfig, InjectionConfig,
                                  PipelineConfig, RealtimeConfig,
                                  RealtimeFeatureService,
                                  RecommenderPlatform)

    n_items = cfg.vocab_size - 256
    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    users = rng.randint(0, N_USERS, N_EVENTS)
    items = rng.randint(0, n_items, N_EVENTS)
    tss = rng.randint(0, 30 * DAY, N_EVENTS)
    store = BatchFeatureStore(FeatureStoreConfig(n_users=N_USERS,
                                                 feature_len=FEATURE_LEN))
    rts = RealtimeFeatureService(RealtimeConfig(n_users=N_USERS,
                                                buffer_len=BUFFER_LEN))
    store.extend(users, items, tss)
    rts.extend(users, items, tss)
    store.run_snapshot(30 * DAY)                 # the daily job
    fu = rng.randint(0, N_USERS, N_FRESH)        # fresh events after it
    fi = rng.randint(0, n_items, N_FRESH)
    ft = np.sort(rng.randint(30 * DAY, 30 * DAY + 7200, N_FRESH))
    store.extend(fu, fi, ft)
    rts.extend(fu, fi, ft)
    pop = np.bincount(items, minlength=n_items).astype(np.float64)
    inj = FeatureInjector(InjectionConfig(policy="inject",
                                          feature_len=FEATURE_LEN),
                          store, rts, device=dev)
    plat = RecommenderPlatform(
        PipelineConfig(n_items=n_items, serve_batch=SERVE_BATCH), cfg,
        params, inj, pop / pop.sum(), device=dev)
    print(f"feature plane: {N_USERS} users, {N_EVENTS} events, snapshot at "
          f"day 30, {N_FRESH} fresh events after it; built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    return plat, rng


def check_slates(plat, users, now, slates):
    items, _, valid = plat.injector.features(users, now)
    n_items = plat.pcfg.n_items
    if slates.shape != (len(users), plat.pcfg.slate_size):
        raise SystemExit(f"slate shape {slates.shape}")
    if slates.min() < 0 or slates.max() >= n_items:
        raise SystemExit("slate item id out of range")
    for row, (s, it, v) in enumerate(zip(slates, items, valid)):
        if len(set(s.tolist())) != len(s):
            raise SystemExit(f"row {row}: duplicate slate items")
        if set(s.tolist()) & set(it[v > 0].tolist()):
            raise SystemExit(f"row {row}: slate holds a watched item")


def run_main_path(dev, gpu, report):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.history_merge.ops import history_merge
    from repro_torch.models import attention as attention_mod
    from repro_torch.models.model import init_params

    cfg = get_config("itfi-ranker")
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         torch.bfloat16, dev)
    plat, rng = build_platform(dev, params, cfg)
    now = 30 * DAY + 7200 + 60
    batches = [rng.choice(N_USERS, SERVE_BATCH, replace=False)
               for _ in range(N_BATCHES + 1)]
    # warm-up batch, recording the ranker's first flash_attention inputs
    rec_fa, fa_calls = record_calls(attention_mod, "flash_attention")
    with rec_fa:
        plat.serve(batches[0], np.full(SERVE_BATCH, now))
    torch.cuda.synchronize()

    history_merge.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    slates = [plat.serve(u, np.full(SERVE_BATCH, now)) for u in batches[1:]]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"history_merge": history_merge.launches,
                "flash_attention": flash_attention.launches}
    print(f"main path: {N_BATCHES} batches x {SERVE_BATCH} inject requests "
          f"through RecommenderPlatform.serve; launches {launches}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the main path never launched: "
                         f"{launches}")
    for u, s in zip(batches[1:], slates):
        check_slates(plat, u, now, s)
    print("main path: every slate holds 10 distinct valid unwatched item ids")
    rps = N_BATCHES * SERVE_BATCH / elapsed
    print(f"time main path bf16: {rps:.1f} requests/s, "
          f"{elapsed / N_BATCHES * 1e3:.2f} ms per batch of {SERVE_BATCH} "
          f"(host clock) [{gpu}]")
    stage_times(plat, batches[1], now, gpu)
    time_flash_at("feature", *fa_calls[0], "prefill shape, the feature "
                  "path's own inputs", report, gpu)
    del fa_calls
    compare_paths_fp32(dev, cfg, plat, batches[1], now)
    return launches, plat, params, now


def stage_times(plat, users, now, gpu):
    """Where a serve batch's time goes: host feature assembly + merge, and
    the device serve core (retrieval + ranker)."""
    import torch
    from repro_torch.core.pipeline import _serve_core, items_to_tokens

    t0 = time.perf_counter()
    items, _, valid = plat.injector.features(users, now)
    torch.cuda.synchronize()
    feat_ms = (time.perf_counter() - t0) * 1e3
    tokens = torch.from_numpy(items_to_tokens(items, valid)).to(plat.device)
    valid_t = torch.from_numpy(valid).to(plat.device)
    with torch.inference_mode():
        core_ms = time_ms(lambda: _serve_core(
            plat.ranker, tokens, valid_t, plat.pop_prior, pcfg=plat.pcfg), 5)
        rank_ms = time_ms(lambda: plat.ranker(tokens, valid=valid_t > 0,
                                              last_only=True), 5)
    print(f"time stages per batch: features+merge {feat_ms:.2f} ms (host "
          f"clock), serve core {core_ms:.3f} ms of which ranker "
          f"{rank_ms:.3f} ms (CUDA events) [{gpu}]")
    tss = np.full(len(users), now)
    t0 = time.perf_counter()
    for _ in range(3):
        plat.serve(users, tss)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    busy_ms, per_kernel = device_ms(lambda: plat.serve(users, tss), 3, 1)
    print(f"time serve batch: {wall_ms:.2f} ms wall (host clock), "
          f"{busy_ms:.3f} ms of kernels on the device, idle share "
          f"{1 - busy_ms / wall_ms:.3f} [{gpu}]")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    for name, ms in top:
        print(f"  kernel {ms:8.4f} ms/batch  {name[:90]}")


def compare_paths_fp32(dev, cfg, plat, users, now):
    """The kernel path against the plain path at fp32 on the same card:
    equal merged features, last-position logits within 1e-4, equal slates
    on every row whose top candidate scores are separated by more than
    that."""
    import torch
    from repro_torch.core import injection as injection_mod
    from repro_torch.core.pipeline import _serve_core, items_to_tokens
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.history_merge.ref import history_merge_ref
    from repro_torch.models import attention as attention_mod
    from repro_torch.models.model import Ranker, init_params

    ranker = Ranker(cfg, init_params(cfg, torch.Generator().manual_seed(SEED),
                                     torch.float32, dev))
    pcfg = plat.pcfg

    def run():
        items, _, valid = plat.injector.features(users, now)
        tokens = torch.from_numpy(items_to_tokens(items, valid)).to(dev)
        valid_t = torch.from_numpy(valid).to(dev)
        with torch.inference_mode():
            last = ranker(tokens, valid=valid_t > 0, last_only=True)[:, -1]
            slate, cand = _serve_core(ranker, tokens, valid_t, plat.pop_prior,
                                      pcfg=pcfg)
        return items, valid, last, slate, cand

    k_items, k_valid, k_last, k_slate, cand = run()
    with mock.patch.object(attention_mod, "flash_attention", attention_ref), \
            mock.patch.object(injection_mod, "history_merge",
                              history_merge_ref):
        p_items, p_valid, p_last, p_slate, p_cand = run()
    if not (np.array_equal(k_items, p_items)
            and np.array_equal(k_valid, p_valid)
            and torch.equal(cand, p_cand)):
        raise SystemExit("kernel and plain paths disagree on features or "
                         "candidates")
    if not torch.isfinite(k_last[:, :cfg.vocab_size]).all():
        raise SystemExit("non-finite logits")
    err = float((k_last - p_last).abs().max())
    torch.testing.assert_close(k_last, p_last, atol=E2E_TOL, rtol=E2E_TOL)
    # a row is separated when its top slate_size+1 candidate scores (the
    # slate and the first one left out) are more than E2E_TOL apart
    scores = torch.gather(p_last, 1, cand + 1)
    dup = ((cand[:, :, None] == cand[:, None, :]) & torch.ones(
        cand.shape[1], cand.shape[1], dtype=torch.bool,
        device=dev).tril(-1)).any(-1)
    top = scores.masked_fill(dup, -1e9).sort(1, descending=True).values[
        :, :pcfg.slate_size + 1]
    gap = (top[:, :-1] - top[:, 1:]).min(1).values
    separated = gap > E2E_TOL
    flipped = (k_slate != p_slate).any(1)
    print(f"fp32 kernel path vs plain path, {len(users)} inject requests: "
          f"merged features equal, last-position logits max abs err "
          f"{err:.3g} (tolerance {E2E_TOL}), {int(flipped.sum())} slates "
          f"differ, {int(separated.sum())} rows separated by > {E2E_TOL}; "
          f"smallest top-score gap of each differing row: "
          f"{[f'{x:.3g}' for x in gap[flipped].tolist()]}")
    if (flipped & separated).any():
        raise SystemExit("a slate differs on a row whose scores are "
                         "separated by more than the tolerance")


# ----------------------------------------------------------------------
# decode_attention
# ----------------------------------------------------------------------

def decode_inputs(dev, dtype, b, w, nq, nkv, hd, seed=SEED):
    """A ring cache whose rows are partly filled, exactly full and
    wrapped, with slots left unstored by left-padded prefills; the slot
    of each row's new token is stored (written before it attends)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dev, dtype) for shape in
               ((b, 1, nq, hd), (b, w, nkv, hd), (b, w, nkv, hd)))
    pos = torch.randint(0, 3 * w, (b,), generator=g, dtype=torch.int32)
    pos[:4] = torch.tensor([0, w // 2, w - 1, w], dtype=torch.int32)
    stored = torch.rand((b, w), generator=g) < 0.85
    stored[torch.arange(b), (pos % w).long()] = True
    return q, k, v, pos.to(dev), stored.to(dev)


def check_decode_attention(dev, report):
    import torch
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    worst = 0.0
    for shape in ((SERVE_BATCH, PANE_CAPACITY, 8, 8, 32),   # the ranker's
                  (SERVE_BATCH, PANE_CAPACITY, 8, 2, 64)):  # GQA
        for dtype in (torch.bfloat16, torch.float32):
            kind = str(dtype).split(".")[1]
            args = decode_inputs(dev, dtype, *shape)
            got = decode_attention(*args)
            want = decode_attention_ref(*args)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise SystemExit(f"decode_attention {kind}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=TOL[kind], rtol=TOL[kind])
            if dtype == torch.bfloat16 and shape[3] == 8:
                worst = err
            print(f"decode_attention {kind} (B, W, nq, nkv, hd)={shape}: max "
                  f"abs err {err:.3g} vs the plain version (tolerance "
                  f"{TOL[kind]})")
    report["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/decode_attention/csrc/"
               "decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:63",
        max_abs_err=worst)


# ----------------------------------------------------------------------
# The token-level path: prefill -> inject -> decode_slate
# ----------------------------------------------------------------------

def pane_inputs(eng, injector, users, now):
    """The Gateway's pane assembly: snapshot histories padded right, fresh
    suffixes (the newest inject_len events) padded left."""
    from repro_torch.core.pipeline import items_to_tokens
    items, _, valid = injector.batch.lookup(users, now)
    toks = items_to_tokens(items, valid)
    hists = [t[v > 0].tolist() for t, v in zip(toks, valid)]
    sfx = injector.fresh_suffix_tokens(users, now, cap=eng.scfg.inject_len)
    return (eng.pad_tokens(hists, eng.scfg.prefill_len),
            eng.pad_tokens(sfx, eng.scfg.inject_len, align="left"))


def serve_pane(eng, hist, sfx, slate_len=SLATE_LEN, times=None):
    """prefill -> inject (prefill logits as the fallback) -> decode_slate;
    with ``times``, appends each phase's ms (host clock, synchronised)."""
    import torch

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if times is not None:
            torch.cuda.synchronize()
            times.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
        return out

    state = phase("prefill", eng.prefill, *hist)
    state = phase("inject", eng.inject, state, *sfx,
                  fallback_logits=state["logits"][:, -1])
    slate = phase("decode_slate", eng.decode_slate, state,
                  state["first_logits"], slate_len)
    return state, slate


def record_calls(module, name):
    """Patch ``module.name`` with a wrapper that keeps a clone of the
    arguments of its first call; returns (patcher, calls)."""
    import torch
    real = getattr(module, name)
    calls = []

    def clone(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    def wrapper(*args, **kwargs):
        if not calls:
            calls.append(([clone(a) for a in args],
                          {k: clone(v) for k, v in kwargs.items()}))
        return real(*args, **kwargs)
    return mock.patch.object(module, name, wrapper), calls


def run_token_path(dev, gpu, plat, params, now, report):
    import torch
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import attention as attention_mod
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = plat.model_cfg
    scfg = ServingConfig(max_batch=SERVE_BATCH, prefill_len=PANE_PREFILL,
                         inject_len=PANE_INJECT, cache_capacity=PANE_CAPACITY)
    eng = ServingEngine(cfg, params, scfg, device=dev)
    rng = np.random.RandomState(SEED + 1)
    panes = [rng.choice(N_USERS, SERVE_BATCH, replace=False)
             for _ in range(N_PANES + 1)]
    t0 = time.perf_counter()
    inputs = [pane_inputs(eng, plat.injector, u, now) for u in panes]
    host_ms = (time.perf_counter() - t0) / len(panes) * 1e3
    n_fresh = np.mean([s[1].sum(1).mean() for _, s in inputs])
    n_hist = np.mean([h[1].sum(1).mean() for h, _ in inputs])
    # warm-up pane, recording the kernels' inputs at the path's shapes
    rec_fa, fa_calls = record_calls(attention_mod, "flash_attention")
    rec_da, da_calls = record_calls(attention_mod, "decode_attention")
    state = eng.prefill(*inputs[0][0])
    with rec_fa:
        state = eng.inject(state, *inputs[0][1],
                           fallback_logits=state["logits"][:, -1])
    with rec_da:
        eng.decode_slate(state, state["first_logits"], SLATE_LEN)
    torch.cuda.synchronize()

    flash_attention.launches = decode_attention.launches = 0
    times = {}
    t0 = time.perf_counter()
    slates = [serve_pane(eng, *inp, times=times)[1] for inp in inputs[1:]]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    print(f"token path: {N_PANES} panes x {SERVE_BATCH} users through "
          f"ServingEngine prefill -> inject -> decode_slate({SLATE_LEN}) "
          f"(mean {n_hist:.1f} history and {n_fresh:.2f} fresh tokens a "
          f"row); launches {launches}, expected decode_attention "
          f"{N_PANES * (SLATE_LEN - 1) * cfg.n_layers}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the token path never launched: "
                         f"{launches}")
    for s in slates:
        if s.shape != (SERVE_BATCH, SLATE_LEN) or s.min() < 0 \
                or s.max() >= cfg.vocab_size:
            raise SystemExit(f"token path: bad slate, shape {s.shape}, "
                             f"range [{s.min()}, {s.max()}]")
        if any(len(set(r.tolist())) != SLATE_LEN for r in s):
            raise SystemExit("token path: a slate repeats a token")
    print(f"token path: every slate holds {SLATE_LEN} distinct token ids "
          f"below {cfg.vocab_size}")
    phases = {k: float(np.mean(v)) for k, v in times.items()}
    print(f"time token path bf16: {N_PANES * SERVE_BATCH / elapsed:.1f} "
          f"requests/s, {elapsed / N_PANES * 1e3:.2f} ms per pane of "
          f"{SERVE_BATCH} (host clock); per pane prefill "
          f"{phases['prefill']:.3f} ms, inject {phases['inject']:.3f} ms, "
          f"decode_slate {phases['decode_slate']:.3f} ms (host clock, "
          f"synchronised), host pane assembly {host_ms:.2f} ms [{gpu}]")
    prefill_logits = SERVE_BATCH * PANE_PREFILL * cfg.vocab_padded * 4
    print(f"token path: prefill returns {prefill_logits / 1e9:.2f} GB of "
          f"f32 logits per pane, of which the path reads [:, -1]")
    time_decode_attention(da_calls[0][0], report, gpu)
    time_flash_at("extend", *fa_calls[0], "extend shape, the token path's "
                  "own inputs", report, gpu)
    profile_pane(eng, inputs[1], gpu)
    from repro_torch.core import injection as injection_mod
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.history_merge.ref import history_merge_ref
    compare_token_paths_fp32(dev, cfg, inputs[1], [
        (attention_mod, "flash_attention", attention_ref),
        (attention_mod, "decode_attention", decode_attention_ref),
        (injection_mod, "history_merge", history_merge_ref)])
    return launches


def time_decode_attention(args, report, gpu):
    """The kernel, its plain version and SDPA at Sq = 1 on the inputs of
    the token path's first decode_attention call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, ring_live)

    q, k, v, pos, stored = args
    b, w, nkv, hd = k.shape
    nq = q.shape[2]
    kind = str(q.dtype).split(".")[1]
    call_ms = time_ms(lambda: decode_attention(*args))
    ms, _ = device_ms(lambda: decode_attention(*args))
    plain_ms, _ = device_ms(lambda: decode_attention_ref(*args), 5, 1)
    live = ring_live(pos, stored)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = live[:, None, None, :]
    gqa = {"enable_gqa": True} if nq != nkv else {}
    library_ms, lib_kernels = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               **gqa))
    n_live = int(live.sum())
    item = q.element_size()
    # q and o once, the K/V rows of live slots once, pos and stored once
    n_bytes = 2 * q.numel() * item + 2 * n_live * nkv * hd * item \
        + 4 * b + b * w
    n_ops = 4 * hd * n_live * nq
    bound_ms, bound_by = bound(n_bytes, n_ops, kind)
    full_ms = 2 * k.numel() * item / HBM_BYTES_PER_S * 1e3
    print(f"time decode_attention {kind} at the token path's inputs (B={b}, "
          f"W={w}, nq={nq}, nkv={nkv}, hd={hd}, {n_live / b:.1f} live slots "
          f"a row): kernel {ms:.4f} ms on the device ({call_ms:.4f} ms per "
          f"wrapper call, CUDA events), plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms ({', '.join(x[:40] for x in lib_kernels)}), "
          f"bound {bound_ms:.5f} ms ({bound_by}, live slots; reading the "
          f"whole cache once would take {full_ms:.4f} ms) [{gpu}]")
    # the same shapes with every slot live (a wrapped, fully stored ring)
    full = (q, k, v, torch.full_like(pos, 2 * w), torch.ones_like(stored))
    got = decode_attention(*full)
    torch.testing.assert_close(got.float(),
                               decode_attention_ref(*full).float(),
                               atol=TOL[kind], rtol=TOL[kind])
    full_kernel_ms, _ = device_ms(lambda: decode_attention(*full))
    full_bound_ms, full_by = bound(
        2 * q.numel() * item + 2 * k.numel() * item + 4 * b + b * w,
        4 * hd * b * w * nq, kind)
    print(f"time decode_attention {kind} on a fully live (wrapped) ring of "
          f"the same shapes: kernel {full_kernel_ms:.4f} ms on the device, "
          f"bound {full_bound_ms:.5f} ms ({full_by}) [{gpu}]")
    report["decode_attention"].update(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=library_ms,
                                      fully_live_ms=full_kernel_ms,
                                      fully_live_bound_ms=full_bound_ms)


def profile_pane(eng, inputs, gpu, label="token"):
    """One pane under the profiler: device-busy time against the host
    clock, and the kernels that take the time."""
    import torch
    t0 = time.perf_counter()
    for _ in range(3):
        serve_pane(eng, *inputs)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    busy_ms, per_kernel = device_ms(lambda: serve_pane(eng, *inputs), 3, 1)
    print(f"time {label} pane: {wall_ms:.2f} ms wall (host clock), "
          f"{busy_ms:.3f} ms of kernels on the device, idle share "
          f"{1 - busy_ms / wall_ms:.3f} [{gpu}]")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  kernel {ms:8.4f} ms/pane  {name[:90]}")
    hist, sfx = inputs
    pre = eng.prefill(*hist)
    inj = eng.inject(pre, *sfx, fallback_logits=pre["logits"][:, -1])
    phases = {
        "prefill": lambda: eng.prefill(*hist),
        "inject": lambda: eng.inject(pre, *sfx,
                                     fallback_logits=pre["logits"][:, -1]),
        "decode_slate": lambda: eng.decode_slate(inj, inj["first_logits"],
                                                 SLATE_LEN)}
    busy = {name: device_ms(fn, 3, 1)[0] for name, fn in phases.items()}
    print(f"time {label} pane device busy by phase: " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in busy.items()) + f" [{gpu}]")
    host_ops(phases["decode_slate"], gpu, label)


def host_ops(fn, gpu, label="token", top=8):
    """The host's side of ``fn()``: the operators that take the most CPU
    time (self time, profiler), and how many times each is called."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    total = sum(e.self_cpu_time_total for e in evts) / 1e3
    calls = sum(e.count for e in evts if e.key.startswith("aten::"))
    print(f"time {label} decode_slate host: {total:.2f} ms of operator CPU "
          f"time, {calls} aten operator calls, nested ones included [{gpu}]")
    for e in sorted(evts, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"  host {e.self_cpu_time_total / 1e3:8.3f} ms  "
              f"{e.count:5d} calls  {e.key[:60]}")


def compare_token_paths_fp32(dev, cfg, inputs, plain, rows=SERVE_BATCH,
                             gen_device="cpu", strict=False):
    """A token path's kernel path against its plain path (``plain``: the
    (module, name, plain version) patches) at fp32 on the card: prefill's
    last-position logits, inject's logits at the real suffix positions
    and the first logits within 1e-4; then, teacher-forced on the plain
    path's picks, every decode step's logits within 1e-4. Slates must be
    equal on every row where no pick's top-2 gap is within 1e-4, and on
    every row with ``strict``."""
    import torch
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingConfig, ServingEngine
    from repro_torch.serving.engine import NEG_INF

    params = init_params(cfg, torch.Generator(device=gen_device).manual_seed(
        SEED), torch.float32, dev)
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=rows, prefill_len=PANE_PREFILL, inject_len=PANE_INJECT,
        cache_capacity=PANE_CAPACITY), device=dev)
    (htoks, hvalid), (stoks, svalid) = inputs
    hist = (htoks[:rows], hvalid[:rows])
    sfx = (stoks[:rows], svalid[:rows])
    live = torch.from_numpy(svalid[:rows]).to(dev)

    def first_state():
        state = eng.prefill(*hist)
        inj = eng.inject(state, *sfx, fallback_logits=state["logits"][:, -1])
        return state["logits"][:, -1], inj

    def steps(state, picks=None):
        """Greedy picks (or the given ones) and each step's logits."""
        dec = eng.finalize(state)
        logits = state["first_logits"]
        mask = torch.zeros_like(logits, dtype=torch.bool)
        rows_ = torch.arange(logits.shape[0], device=dev)
        out_picks, out_logits, gaps = [], [logits], []
        for i in range(SLATE_LEN):
            masked = torch.where(mask, NEG_INF, logits)
            top2 = masked.topk(2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            tok = masked.argmax(-1).to(torch.int32) if picks is None \
                else picks[i]
            out_picks.append(tok)
            mask[rows_, tok.long()] = True
            if i < SLATE_LEN - 1:
                logits, dec = eng.decode(dec, tok[:, None])
                out_logits.append(logits)
        return out_picks, out_logits, torch.stack(gaps, 1)

    with contextlib.ExitStack() as stack:
        for module, name, fn in plain:
            stack.enter_context(mock.patch.object(module, name, fn))
        p_pre, p_state = first_state()
        p_slate = eng.decode_slate(p_state, p_state["first_logits"],
                                   SLATE_LEN)
        p_picks, p_logits, gaps = steps(p_state)
    if not np.array_equal(torch.stack(p_picks, 1).cpu().numpy(), p_slate):
        raise SystemExit("the plain path's step loop and decode_slate "
                         "disagree")
    k_pre, k_state = first_state()
    k_slate = eng.decode_slate(k_state, k_state["first_logits"], SLATE_LEN)
    _, k_logits, _ = steps(k_state, picks=p_picks)
    pairs = [("prefill", k_pre, p_pre),
             ("inject", k_state["logits"][live], p_state["logits"][live])]
    pairs += [(f"step {i}", kl, pl)
              for i, (kl, pl) in enumerate(zip(k_logits, p_logits))]
    errs = {}
    for name, kl, pl in pairs:
        if not torch.isfinite(kl[..., :cfg.vocab_size]).all():
            raise SystemExit(f"{cfg.name} token path: non-finite logits "
                             f"({name})")
        errs[name] = float((kl - pl).abs().max())
        torch.testing.assert_close(kl, pl, atol=E2E_TOL, rtol=E2E_TOL)
    separated = (gaps > E2E_TOL).all(1).cpu().numpy()
    flipped = (k_slate != p_slate).any(1)
    steps_err = max(v for k, v in errs.items() if k.startswith("step "))
    print(f"fp32 {cfg.name} token path, kernels vs plain versions, {rows} "
          f"rows: prefill last logits max abs err {errs['prefill']:.3g}, "
          f"inject logits {errs['inject']:.3g}, first logits "
          f"{errs['step 0']:.3g}, teacher-forced decode steps "
          f"{steps_err:.3g} (tolerance {E2E_TOL}); {int(flipped.sum())} "
          f"slates differ, {int(separated.sum())} rows with every top-2 gap "
          f"> {E2E_TOL}")
    if strict and flipped.any():
        raise SystemExit(f"{cfg.name} token path: a slate differs between "
                         "the kernel and the plain path")
    if (flipped & separated).any():
        raise SystemExit("a token-path slate differs on a row whose picks "
                         "are separated by more than the tolerance")


# ----------------------------------------------------------------------
# ssd_scan and the Mamba2 token path
# ----------------------------------------------------------------------

def ssd_inputs(dev, dtype, b, s, nh, hp, ds, seed=SEED, padded=True):
    """SSD inputs as mamba2's layers see them: with ``padded``, row 0
    left-padded and the last row all padding (dt = 0, identity steps);
    else every position live (a user with a full history); a random f32
    state."""
    import torch
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((b, s, nh, hp), generator=g) * 0.5).to(dev, dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, nh), generator=g) - 2.0)
    if padded:
        dt[0, : s // 3] = 0.0
        dt[-1] = 0.0
    A = -torch.exp(torch.log(torch.arange(1, nh + 1, dtype=torch.float32)))
    B, C = ((torch.randn((b, s, ds), generator=g) * 0.3).to(dev, dtype)
            for _ in range(2))
    D = torch.ones((nh,))
    h0 = torch.randn((b, nh, hp, ds), generator=g)
    return [x, dt.to(dev), A.to(dev), B, C, D.to(dev)], h0.to(dev)


def ssd_work(args, chunk, init_state):
    """Bytes moved and operations needed for these inputs: x, dt, A, B, C,
    D and the initial state read once, y and the final state written once;
    the multiply-adds these inputs need: the causal pairs of live (dt != 0)
    positions in each chunk (C.B^T once a row, G X per head), the state
    update per live position and head, and C.state per position and head
    wherever the state entering the chunk is not zero (every position when
    an initial state is given, padded ones too)."""
    x, dt, A, B, C, D = args
    b, s, nh, hp = x.shape
    ds = B.shape[-1]
    item = x.element_size()
    n_bytes = (2 * x.numel() + B.numel() + C.numel()) * item \
        + 4 * (dt.numel() + 2 * nh + b * nh * hp * ds
               * (2 if init_state is not None else 1))
    live = (dt != 0).reshape(b, s // chunk, chunk, nh).double()
    per_head = live.sum(2)                            # (b, nc, nh)
    per_row = live.amax(3).sum(2)                     # (b, nc)
    pairs_h = float((per_head * (per_head + 1) / 2).sum())
    pairs_r = float((per_row * (per_row + 1) / 2).sum())
    # the state entering chunk c is not zero: a live position before it
    before = per_head.cumsum(1) - per_head            # (b, nc, nh)
    inter = chunk * float((before > 0).sum() if init_state is None
                          else before.numel())
    n_ops = 2 * (hp * pairs_h + ds * pairs_r
                 + hp * ds * (float(live.sum()) + inter))
    return n_bytes, n_ops


def ssd_plain(x, dt, A, B, C, D, *, chunk=256, init_state=None):
    """``ops.ssd_scan``'s contract on the plain version, for any device."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, D, chunk=min(chunk, x.shape[1]),
                       init_state=init_state)


def ssd_truth(x, dt, A, B, C, D, h0=None):
    """The recurrence token by token in float64, the ground truth that the
    fp32 tolerance is set from."""
    import torch
    xd, dtd, Bd, Cd = (t.double() for t in (x, dt, B, C))
    A, D = A.double(), D.double()
    b, s, nh, hp = x.shape
    h = (torch.zeros((b, nh, hp, B.shape[-1]), dtype=torch.float64,
                     device=x.device) if h0 is None else h0.double())
    ys = []
    for t in range(s):
        a = torch.exp(dtd[:, t] * A)
        h = a[:, :, None, None] * h + torch.einsum(
            "bh,bhp,bs->bhps", dtd[:, t], xd[:, t], Bd[:, t])
        ys.append(torch.einsum("bs,bhps->bhp", Cd[:, t], h)
                  + D[None, :, None] * xd[:, t])
    return torch.stack(ys, 1), h


def check_ssd_scan(dev, report):
    """The kernel against its plain version at mamba2-780m's prefill and
    inject shapes and a smaller head/state/chunk set, bf16 and fp32, with
    padded rows; a row that is all padding keeps its state bit for bit;
    bad inputs raise.

    Tolerances: bf16 3e-2 on y (y is rounded to bf16 once); fp32 2e-5 on
    y and 1e-4 on the final state, each widened by twice the plain
    version's own error against the float64 recurrence. With mamba2's
    decays (A down to -48) the in-chunk cumulative sums of dt * A reach
    ~1e3, where an f32 ulp is ~1e-4, so exp(cum_i - cum_j) carries that
    relative error in any chunked scan; the check asks the kernel to be
    as accurate as its plain version, not to repeat its rounding."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    shapes = [("prefill", (MAMBA_BATCH, PANE_PREFILL, 48, 64, 128), 256,
                   False, True),
                  ("inject", (MAMBA_BATCH, PANE_INJECT, 48, 64, 128), 256,
                   True, True),
                  ("small", (8, 96, 8, 32, 64), 32, True, True),
                  ("fully live prefill",
                   (MAMBA_BATCH, PANE_PREFILL, 48, 64, 128), 256, False,
                   False)]
    worst = 0.0
    for name, shape, chunk, init, padded in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            kind = str(dtype).split(".")[1]
            args, h0 = ssd_inputs(dev, dtype, *shape, padded=padded)
            h0 = h0 if init else None
            y, h = ssd_scan(*args, chunk=chunk, init_state=h0)
            yw, hw = ssd_plain(*args, chunk=chunk, init_state=h0)
            torch.cuda.synchronize()
            if not (torch.isfinite(y.float()).all() and
                    torch.isfinite(h).all()):
                raise SystemExit(f"ssd_scan {name} {kind}: non-finite output")
            err = float((y.float() - yw.float()).abs().max())
            herr = float((h - hw).abs().max())
            ytol, htol, truth = TOL[kind], 1e-4, ""
            if dtype == torch.float32:
                yt, ht = ssd_truth(*args, h0)
                e = [float((v.double() - t).abs().max())
                     for v, t in ((y, yt), (yw, yt), (h, ht), (hw, ht))]
                ytol, htol = ytol + 2 * e[1], htol + 2 * e[3]
                truth = (f"; against the float64 recurrence: kernel y "
                         f"{e[0]:.3g}, plain y {e[1]:.3g}, kernel state "
                         f"{e[2]:.3g}, plain state {e[3]:.3g}")
                del yt, ht
            torch.testing.assert_close(y.float(), yw.float(), atol=ytol,
                                       rtol=ytol)
            torch.testing.assert_close(h, hw, atol=htol, rtol=htol)
            kept = h0[-1] if init else torch.zeros_like(h[-1])
            if padded and not torch.equal(h[-1], kept):
                raise SystemExit(f"ssd_scan {name} {kind}: an all-padding "
                                 "row changed its state")
            if name == "prefill" and dtype == torch.bfloat16:
                worst = err
            print(f"ssd_scan {kind} {name} (b, s, nh, hp, ds)={shape} chunk "
                  f"{min(chunk, shape[1])}{' from a random state' if init else ''}"
                  f": y max abs err {err:.3g} (tolerance {ytol:.3g}), final "
                  f"state {herr:.3g} (tolerance {htol:.3g}) vs the plain "
                  f"version{truth}"
                  f"{'; the all-padding row keeps its state' if padded else ''}")
    args, h0 = ssd_inputs(dev, torch.float32, 2, 64, 4, 32, 32)
    bad = {"dt in bf16": dict(dt=args[1].bfloat16()),
           "B not in x's dtype": dict(B=args[3].bfloat16()),
           "chunk 48 of 64": dict(chunk=48),
           "head_dim 16": dict(x=args[0][..., :16].contiguous()),
           "a state on the CPU": dict(init_state=h0.cpu())}
    for what, kw in bad.items():
        call = dict(zip(("x", "dt", "A", "B", "C", "D"), args), chunk=32)
        call.update(kw)
        try:
            ssd_scan(**call)
        except ValueError:
            continue
        raise SystemExit(f"ssd_scan accepted bad input: {what}")
    print(f"ssd_scan rejects bad inputs: {', '.join(bad)}")
    report["ssd_scan"] = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:77",
        max_abs_err=worst, library_ms=None)


def time_ssd_scan(args, kwargs, label, gpu):
    """The kernel and its plain version at one of the Mamba2 path's own
    ssd_scan calls; returns (ms, plain_ms, bound_ms, bound_by)."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    x = args[0]
    kind = str(x.dtype).split(".")[1]
    call_ms = time_ms(lambda: ssd_scan(*args, **kwargs), 10, 2)
    ms, _ = device_ms(lambda: ssd_scan(*args, **kwargs), 10, 2)
    plain_ms, _ = device_ms(lambda: ssd_plain(*args, **kwargs), 3, 1)
    chunk = min(kwargs.get("chunk", 256), x.shape[1])
    n_bytes, n_ops = ssd_work(args, chunk, kwargs.get("init_state"))
    bound_ms, bound_by = bound(n_bytes, n_ops, kind)
    live = float((args[1] != 0).float().mean())
    print(f"time ssd_scan {kind} at the {label} shape (b, s, nh, hp, ds)="
          f"{tuple(x.shape) + (args[3].shape[-1],)}, chunk {chunk}, "
          f"{live:.3f} of positions live: kernel {ms:.4f} ms on the device "
          f"({call_ms:.4f} ms per wrapper call, CUDA events), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
          f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP live) [{gpu}]")
    return ms, plain_ms, bound_ms, bound_by


def run_mamba2_path(dev, gpu, plat, now, report):
    """The registered mamba2-780m at full width (48 SSM layers, bf16
    weights from a seeded generator on the card) through ServingEngine
    prefill -> inject -> decode_slate, panes of MAMBA_BATCH users from the
    feature plane; then the kernel's times at the path's own inputs, one
    profiled pane and the fp32 comparison on a smaller pane."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = get_config("mamba2-780m")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         torch.bfloat16, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    scfg = ServingConfig(max_batch=MAMBA_BATCH, prefill_len=PANE_PREFILL,
                         inject_len=PANE_INJECT, cache_capacity=PANE_CAPACITY)
    eng = ServingEngine(cfg, params, scfg, device=dev)
    print(f"mamba2 path: {cfg.name}, {cfg.n_layers} SSM layers, d "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.n_ssm_heads} SSD heads "
          f"of {cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, chunk "
          f"{cfg.ssm.chunk_size}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f}"
          f" B bf16 params made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(SEED + 2)
    panes = [rng.choice(N_USERS, MAMBA_BATCH, replace=False)
             for _ in range(N_PANES + 1)]
    inputs = [pane_inputs(eng, plat.injector, u, now) for u in panes]
    n_fresh = np.mean([s[1].sum(1).mean() for _, s in inputs])
    n_hist = np.mean([h[1].sum(1).mean() for h, _ in inputs])
    # warm-up pane, recording ssd_scan's inputs at the path's two shapes
    torch.cuda.reset_peak_memory_stats(dev)
    rec_pre, pre_calls = record_calls(ssm_mod, "ssd_scan")
    rec_inj, inj_calls = record_calls(ssm_mod, "ssd_scan")
    with rec_pre:
        state = eng.prefill(*inputs[0][0])
    with rec_inj:
        state = eng.inject(state, *inputs[0][1],
                           fallback_logits=state["logits"][:, -1])
    eng.decode_slate(state, state["first_logits"], SLATE_LEN)
    del state
    torch.cuda.synchronize()

    ssd_scan.launches = 0
    times = {}
    t0 = time.perf_counter()
    slates = [serve_pane(eng, *inp, times=times)[1] for inp in inputs[1:]]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"ssd_scan": ssd_scan.launches}
    per_pane = ssd_scan.launches / N_PANES
    print(f"mamba2 path: {N_PANES} panes x {MAMBA_BATCH} users through "
          f"ServingEngine prefill -> inject -> decode_slate({SLATE_LEN}) "
          f"(mean {n_hist:.1f} history and {n_fresh:.2f} fresh tokens a "
          f"row); launches {launches}, {per_pane:g} a pane (expected "
          f"{2 * cfg.n_layers}: {cfg.n_layers} in prefill, {cfg.n_layers} in "
          f"inject)")
    if per_pane != 2 * cfg.n_layers:
        raise SystemExit(f"mamba2 path: ssd_scan launched {per_pane:g} times "
                         f"a pane, not {2 * cfg.n_layers}")
    for s in slates:
        if s.shape != (MAMBA_BATCH, SLATE_LEN) or s.min() < 0 \
                or s.max() >= cfg.vocab_size:
            raise SystemExit(f"mamba2 path: bad slate, shape {s.shape}, "
                             f"range [{s.min()}, {s.max()}]")
        if any(len(set(r.tolist())) != SLATE_LEN for r in s):
            raise SystemExit("mamba2 path: a slate repeats a token")
    print(f"mamba2 path: every slate holds {SLATE_LEN} distinct token ids "
          f"below {cfg.vocab_size}")
    phases = {k: float(np.mean(v)) for k, v in times.items()}
    print(f"time mamba2 path bf16: {N_PANES * MAMBA_BATCH / elapsed:.1f} "
          f"requests/s, {elapsed / N_PANES * 1e3:.2f} ms per pane of "
          f"{MAMBA_BATCH} (host clock); per pane prefill "
          f"{phases['prefill']:.3f} ms, inject {phases['inject']:.3f} ms, "
          f"decode_slate {phases['decode_slate']:.3f} ms (host clock, "
          f"synchronised); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB [{gpu}]")
    ms, plain_ms, bound_ms, bound_by = time_ssd_scan(
        *pre_calls[0], "prefill", gpu)
    time_ssd_scan(*inj_calls[0], "inject", gpu)
    live_args, _ = ssd_inputs(dev, torch.bfloat16, MAMBA_BATCH, PANE_PREFILL,
                              cfg.n_ssm_heads, cfg.ssm.head_dim,
                              cfg.ssm.d_state, padded=False)
    time_ssd_scan(live_args, dict(chunk=cfg.ssm.chunk_size),
                  "fully live prefill", gpu)
    del live_args
    report["ssd_scan"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
    del pre_calls, inj_calls
    profile_pane(eng, inputs[1], gpu, label="mamba2")
    del eng, params
    torch.cuda.empty_cache()
    compare_token_paths_fp32(dev, cfg, inputs[1],
                             [(ssm_mod, "ssd_scan", ssd_plain)],
                             rows=MAMBA_FP32_ROWS, gen_device=dev,
                             strict=True)
    return launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = card()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    names = _build.kernel_names()
    _build.build(names)
    print(f"built {', '.join(names)} with nvcc in "
          f"{time.perf_counter() - t0:.1f} s")

    report = {}
    check_history_merge(dev, report, gpu)
    check_flash_attention(dev, report, gpu)
    launches, plat, params, now = run_main_path(dev, gpu, report)
    check_decode_attention(dev, report)
    token_launches = run_token_path(dev, gpu, plat, params, now, report)
    check_ssd_scan(dev, report)
    ssm_launches = run_mamba2_path(dev, gpu, plat, now, report)
    missing = set(names) ^ set(report)
    if missing:
        raise SystemExit(f"kernels without a check: {sorted(missing)}")
    for name, n in (*token_launches.items(), *ssm_launches.items()):
        launches[name] = launches.get(name, 0) + n
    kernels = [dict(report[n], launches=launches[n]) for n in names]
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
