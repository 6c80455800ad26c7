#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``src/repro_torch``) on one GPU and checks it.

    python3 chip_smoke.py

1. builds every CUDA kernel of the port from ``src/repro_torch/**/csrc/*.cu``
   (one ``nvcc`` per source, all started together);
2. holds ``history_merge`` bit for bit against its plain PyTorch version,
   at the serving design point and on adversarial rows;
3. holds ``flash_attention`` against its plain version at the ranker's
   shapes, in bf16 and fp32;
4. drives the feature-level injection path, ``RecommenderPlatform.serve``
   with policy "inject", at the full width of the registered
   ``itfi-ranker`` over a 100k-user / 3.2M-event feature plane, counting
   kernel launches, then compares the kernel path with the plain path at
   fp32 on the same card;
5. times each kernel, its plain version and a PyTorch library call with
   CUDA events, and the path in requests/s.

It needs a CUDA device: without one it exits non-zero and prints no result.
The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
    without the host's launch overhead or the gaps between kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_kernel = {e.key: _device_us(e) / 1e3 / iters
                  for e in prof.key_averages() if _device_us(e) > 0}
    total = sum(per_kernel.values())
    if total <= 0:
        raise SystemExit("the profiler recorded no device time")
    return total, per_kernel


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


def attention_work(q, kvalid, itemsize):
    """Bytes moved and operations needed for these inputs: q/k/v/o, the
    positions and the key mask once; 4*hd products per live (query, key)
    pair and head, and hd adds per key for a row with no live key (the
    uniform average of V)."""
    b, s, heads, hd = q.shape
    n_bytes = 4 * q.numel() * itemsize + 2 * 4 * b * s + b * s
    # left padding: keys [pad, s) are valid, and query i sees keys
    # [pad, i] of them
    pad = (s - kvalid.sum(1)).cpu().numpy()
    per_row = np.maximum(0, np.arange(s)[None, :] - pad[:, None] + 1)
    dead_rows = (per_row == 0).sum()
    n_ops = heads * (4 * hd * per_row.sum() + hd * s * dead_rows)
    return n_bytes, float(n_ops)


def check_flash_attention(dev, report, gpu):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                         attention_mask,
                                                         attention_ref)

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

        q, k, v, qpos, kpos, kvalid = args
        call_ms = time_ms(lambda: flash_attention(*args))
        ms, _ = device_ms(lambda: flash_attention(*args))
        plain_ms, _ = device_ms(lambda: attention_ref(*args), 5, 1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        bias = torch.where(attention_mask(qpos, kpos, kvalid), 0.0,
                           NEG_INF).to(dtype)[:, None]
        library_ms, lib_kernels = device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias))
        n_bytes, n_ops = attention_work(q, kvalid, q.element_size())
        bound_ms, bound_by = bound(n_bytes, n_ops, kind)
        print(f"time flash_attention {kind}: kernel {ms:.4f} ms on the device "
              f"({call_ms:.4f} ms per wrapper call, CUDA events), plain "
              f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
              f"({', '.join(k[:40] for k in lib_kernels)}), bound "
              f"{bound_ms:.4f} ms ({bound_by}) [{gpu}]")
        if dtype == torch.bfloat16:  # the main path's dtype
            report["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/"
                         "flash_attention.py:93",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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


def run_main_path(dev, gpu):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.history_merge.ops import history_merge
    from repro_torch.models.model import init_params

    cfg = get_config("itfi-ranker")
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         torch.bfloat16, dev)
    plat, rng = build_platform(dev, params, cfg)
    now = 30 * DAY + 7200 + 60
    batches = [rng.choice(N_USERS, SERVE_BATCH, replace=False)
               for _ in range(N_BATCHES + 1)]
    plat.serve(batches[0], np.full(SERVE_BATCH, now))  # warm-up
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
    compare_paths_fp32(dev, cfg, plat, batches[1], now)
    return launches


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
    separated = ((top[:, :-1] - top[:, 1:]) > E2E_TOL).all(1)
    flipped = (k_slate != p_slate).any(1)
    print(f"fp32 kernel path vs plain path, {len(users)} inject requests: "
          f"merged features equal, last-position logits max abs err "
          f"{err:.3g} (tolerance {E2E_TOL}), {int(flipped.sum())} slates "
          f"differ, {int(separated.sum())} rows separated by > {E2E_TOL}")
    if (flipped & separated).any():
        raise SystemExit("a slate differs on a row whose scores are "
                         "separated by more than the tolerance")


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
    launches = run_main_path(dev, gpu)
    missing = set(names) ^ set(report)
    if missing:
        raise SystemExit(f"kernels without a check: {sorted(missing)}")
    kernels = [dict(report[n], launches=launches[n]) for n in names]
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
