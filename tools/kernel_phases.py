#!/usr/bin/env python3
"""Where a kernel's time goes: copies of the port's ``decode_attention`` and
``history_merge`` CUDA sources with one phase cut out, and load/store
kernels of the same access patterns, timed on one GPU at the paths' own
inputs.

    python3 tools/kernel_phases.py [--src LABEL=DIR ...] [--out FILE]

Each ``--src`` names a ``kernels`` directory (``<checkout>/src/repro_torch/
kernels``) whose two sources are cut; the default is this checkout's.
``--out`` (default ``build/phases/kernel_phases.json``) gets every row. To
time an older tree beside this one, unpack it (``git archive``) into a
directory that ``.gitignore`` lists and pass both, e.g.
``--src old=build/parent/src/repro_torch/kernels --src new=src/repro_torch/kernels``.
A cut whose text is not in a source is skipped, so one list serves the
sources before and after the kernels' redesign. Every variant is built with
the port's ``nvcc`` flags (one ``nvcc`` a source, all started together)
under ``build/phases/``, called through its C launch function, and timed
from a profiler trace (device time of the kernel alone, as
``chip_smoke.py`` times kernels). Uncut variants are also held against the
plain versions.

Inputs: ``decode_attention`` at the token path's first call (recorded from
a pane of ``chip_smoke.py``'s token path on the full-width ``itfi-ranker``)
and on a fully live (wrapped) ring of the same shape; ``history_merge`` at
``chip_smoke.py``'s design point (B = 256, Lb = 256, Lr = 64, K = 256) and
at the feature path's own first call. decode_attention is timed warm
(repeated calls on one input, as ``chip_smoke.py`` does) and cold (a 64 MB
write between calls, so the live rows are not in L2).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
OUT_DIR = os.path.join(ROOT, "build", "phases")

# (kernel, variant, [(text, replacement), ...]); the first variant of each
# kernel is the source as it is
CUTS = [
    ("decode_attention", "as it is", []),
    # the one-CTA-per-(KV head, row) kernel that reads every slot
    ("decode_attention", "no staging (no K/V loads)", [(
        "        unpack<T>(*reinterpret_cast<const uint4*>(k + off), kx);\n"
        "        unpack<T>(*reinterpret_cast<const uint4*>(v + off), vx);\n",
        "#pragma unroll\n"
        "        for (int i = 0; i < VEC; ++i) kx[i] = vx[i] = (float)(off & 7);\n")]),
    ("decode_attention", "no QK", [(
        "      for (int d = 0; d < HD; ++d) dot += qh[d] * krow[d];",
        "      for (int d = 0; d < 1; ++d) dot += qh[d] * krow[d];")]),
    ("decode_attention", "no PV", [(
        "      for (int jj = 0; jj < kTile; ++jj) {",
        "      for (int jj = 0; jj < 0; ++jj) {")]),
    # the live-list kernel
    ("decode_attention", "no K/V copies", [(
        "          cp_async16((is_v ? vbuf : kbuf)",
        "          if (from == nullptr) cp_async16((is_v ? vbuf : kbuf)")]),
    ("decode_attention", "no QK", [(
        "              for (int c = 0; c < CH; ++c) {",
        "              for (int c = 0; c < 0; ++c) {")]),
    ("decode_attention", "no PV", [(
        "          for (int jj = kg; jj < ne; jj += KS) {",
        "          for (int jj = kg; jj < 0; jj += KS) {")]),
    ("decode_attention", "3-stage ring", [(
        "constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    ("decode_attention", "CTA per (row, 4 KV heads)", [(
        "constexpr int kPitchMax = 512;", "constexpr int kPitchMax = 256;")]),
    ("decode_attention", "CTA per (row, 2 KV heads)", [(
        "constexpr int kPitchMax = 512;", "constexpr int kPitchMax = 128;")]),
    ("history_merge", "as it is", []),
    # the pairwise-rank kernel
    ("history_merge", "no dup pass", [(
        "for (int j = 0; alive && j < n; ++j)",
        "for (int j = 0; alive && j < 0; ++j)")]),
    ("history_merge", "no rank pass", [(
        "for (int j = 0; j < n; ++j) rank +=",
        "for (int j = 0; j < 0; ++j) rank +=")]),
    ("history_merge", "no zero-fill and scatter", [
        ("for (int s = threadIdx.x; s < k; s += blockDim.x) {",
         "for (int s = threadIdx.x; s < 0; s += blockDim.x) {"),
        ("    if (rank < k) {", "    if (rank < k - (1 << 30)) {")]),
    # the hash-and-sort kernel
    ("history_merge", "no hash table", [(
        "    if (!valid[u]) continue;\n",
        "    if (!valid[u] || lb >= 0) { slot[u] = 0; continue; }\n")]),
    ("history_merge", "no sort", [(
        "  for (int kk = 2; kk <= L.p; kk <<= 1) {",
        "  for (int kk = 2; kk <= 0; kk <<= 1) {")]),
    ("history_merge", "no output", [(
        "  for (int s = tid; s < k; s += nt) {",
        "  for (int s = tid; s < 0; s += nt) {")]),
]

LOAD_STORE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// every slot's K and V piece of one KV head, 16 bytes a thread, one CTA
// per (KV head, row): the access pattern of a kernel that reads all of W
__global__ void ls_all_slots(const uint4* k, const uint4* v, uint4* o, int w,
                             int nkv, int cpr) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int c = threadIdx.x; c < w * cpr; c += blockDim.x) {
    const size_t off = (((size_t)b * w + c / cpr) * nkv + kvh) * cpr + c % cpr;
    const uint4 x = k[off], y = v[off];
    acc.x ^= x.x ^ y.x; acc.y ^= x.y ^ y.y; acc.z ^= x.z ^ y.z; acc.w ^= x.w ^ y.w;
  }
  if (threadIdx.x < cpr) o[((size_t)b * nkv + kvh) * cpr + threadIdx.x] = acc;
}

// only the live slots' K and V runs of all KV heads, one CTA per row
__global__ void ls_live_slots(const uint4* k, const uint4* v, const int* pos,
                              const uint8_t* stored, uint4* o, int w, int run) {
  extern __shared__ int list[];
  __shared__ int n;
  const int b = blockIdx.x, p = pos[b];
  if (threadIdx.x == 0) n = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < w; j += blockDim.x)
    if ((j <= p || p >= w) && stored[(size_t)b * w + j]) list[atomicAdd(&n, 1)] = j;
  __syncthreads();
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int c = threadIdx.x; c < n * run; c += blockDim.x) {
    const size_t off = ((size_t)b * w + list[c / run]) * run + c % run;
    const uint4 x = k[off], y = v[off];
    acc.x ^= x.x ^ y.x; acc.y ^= x.y ^ y.y; acc.z ^= x.z ^ y.z; acc.w ^= x.w ^ y.w;
  }
  if (threadIdx.x < run) o[(size_t)b * run + threadIdx.x] = acc;
}

// the whole cache, streamed in 16-byte loads over the whole card
__global__ void ls_stream(const uint4* k, const uint4* v, uint4* o, size_t n) {
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint4 x = k[i], y = v[i];
    acc.x ^= x.x ^ y.x; acc.y ^= x.y ^ y.y; acc.z ^= x.z ^ y.z; acc.w ^= x.w ^ y.w;
  }
  if ((acc.x ^ acc.y ^ acc.z ^ acc.w) == 0x9e3779b9u) o[0] = acc;
}

// a merge's reads (N events of 3 ints) and writes (K slots of 3 ints), one
// CTA per row
__global__ void ls_merge(const int* bi, const int* bt, const int* bv,
                         const int* ri, const int* rt, const int* rv, int* oi,
                         int* ot, int* ov, int lb, int lr, int k) {
  const long long row = blockIdx.x;
  int acc = 0;
  for (int i = threadIdx.x; i < lb; i += blockDim.x)
    acc ^= bi[row * lb + i] ^ bt[row * lb + i] ^ bv[row * lb + i];
  for (int i = threadIdx.x; i < lr; i += blockDim.x)
    acc ^= ri[row * lr + i] ^ rt[row * lr + i] ^ rv[row * lr + i];
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    oi[row * k + s] = acc;
    ot[row * k + s] = acc;
    ov[row * k + s] = acc;
  }
}

extern "C" int ls_launch(int which, const void* a0, const void* a1,
                         const void* a2, const void* a3, const void* a4,
                         const void* a5, void* o0, void* o1, void* o2,
                         long long i0, long long i1, long long i2,
                         long long i3, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (which == 0)       // k, v, o; b, w, nkv, cpr
    ls_all_slots<<<dim3((int)i2, (int)i0), 128, 0, st>>>(
        (const uint4*)a0, (const uint4*)a1, (uint4*)o0, (int)i1, (int)i2, (int)i3);
  else if (which == 1)  // k, v, pos, stored, o; b, w, run
    ls_live_slots<<<(int)i0, 256, (size_t)i1 * 4, st>>>(
        (const uint4*)a0, (const uint4*)a1, (const int*)a2,
        (const uint8_t*)a3, (uint4*)o0, (int)i1, (int)i2);
  else if (which == 2)  // k, v, o; 16-byte chunks
    ls_stream<<<132 * 8, 256, 0, st>>>((const uint4*)a0, (const uint4*)a1,
                                       (uint4*)o0, (size_t)i0);
  else                  // the merge's six inputs and three outputs; b, lb, lr, k
    ls_merge<<<(int)i0, 256, 0, st>>>(
        (const int*)a0, (const int*)a1, (const int*)a2, (const int*)a3,
        (const int*)a4, (const int*)a5, (int*)o0, (int*)o1, (int*)o2,
        (int)i1, (int)i2, (int)i3);
  return (int)cudaGetLastError();
}
"""


def build_all(sources):
    """{key: .cu path} -> {key: loaded CDLL}; one nvcc each, in parallel."""
    from repro_torch.kernels import _build
    procs = {}
    for key, src in sources.items():
        lib = os.path.join(OUT_DIR, f"{key}.so")
        procs[key] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(lib)
    return libs


def variants(src_dirs):
    """{key: (label, kernel, variant, .cu path)} for every cut that applies."""
    out = {}
    for label, kdir in src_dirs:
        for i, (kernel, name, cuts) in enumerate(CUTS):
            with open(os.path.join(kdir, kernel, "csrc", f"{kernel}.cu")) as f:
                text = f.read()
            if any(a not in text for a, _ in cuts):
                continue
            for a, b in cuts:
                text = text.replace(a, b)
            key = f"{label}_{kernel}_{i}"
            path = os.path.join(OUT_DIR, f"{key}.cu")
            with open(path, "w") as f:
                f.write(text)
            out[key] = (label, kernel, name, path)
    return out


def record_inputs(dev):
    """The token path's first decode_attention inputs and the feature
    path's first history_merge inputs, from chip_smoke.py's set-up."""
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import injection as injection_mod
    from repro_torch.models import attention as attention_mod
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = get_config("itfi-ranker")
    params = init_params(cfg, torch.Generator().manual_seed(cs.SEED),
                         torch.bfloat16, dev)
    plat, rng = cs.build_platform(dev, params, cfg)
    now = 30 * cs.DAY + 7200 + 60
    users = rng.choice(cs.N_USERS, cs.SERVE_BATCH, replace=False)
    rec_hm, hm_calls = cs.record_calls(injection_mod, "history_merge")
    with rec_hm:
        plat.serve(users, np.full(cs.SERVE_BATCH, now))
    scfg = ServingConfig(max_batch=cs.SERVE_BATCH,
                         prefill_len=cs.PANE_PREFILL,
                         inject_len=cs.PANE_INJECT,
                         cache_capacity=cs.PANE_CAPACITY)
    eng = ServingEngine(cfg, params, scfg, device=dev)
    hist, sfx = cs.pane_inputs(eng, plat.injector, users, now)
    rec_da, da_calls = cs.record_calls(attention_mod, "decode_attention")
    state = eng.prefill(*hist)
    state = eng.inject(state, *sfx, fallback_logits=state["logits"][:, -1])
    with rec_da:
        eng.decode_slate(state, state["first_logits"], cs.SLATE_LEN)
    torch.cuda.synchronize()
    return da_calls[0][0], hm_calls[0]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[],
                    help="LABEL=DIR of a kernels directory to cut")
    ap.add_argument("--out", default=os.path.join(OUT_DIR,
                                                  "kernel_phases.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, ring_live)
    from repro_torch.kernels.history_merge.ref import history_merge_ref

    src_dirs = [tuple(s.split("=", 1)) for s in args.src] or \
        [("this", os.path.join(ROOT, "src", "repro_torch", "kernels"))]
    os.makedirs(OUT_DIR, exist_ok=True)
    gpu = cs.card()
    dev = torch.device("cuda")
    var = variants(src_dirs)
    ls_src = os.path.join(OUT_DIR, "load_store.cu")
    with open(ls_src, "w") as f:
        f.write(LOAD_STORE)
    t0 = time.perf_counter()
    libs = build_all({**{k: v[3] for k, v in var.items()},
                      "load_store": ls_src})
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")

    da_args, (hm_args, hm_kw) = record_inputs(dev)
    q, k, v, pos, stored = da_args
    b, w, nkv, hd = k.shape
    nq = q.shape[2]
    full = (q, k, v, torch.full_like(pos, 2 * w),
            torch.ones_like(stored))
    rng = np.random.RandomState(cs.SEED)
    design = cs.merge_inputs(rng, cs.SERVE_BATCH, cs.FEATURE_LEN,
                             cs.BUFFER_LEN, 4864, 10**6, dev)
    inputs = {
        "decode_attention": {"path": da_args, "fully live": full},
        "history_merge": {"design point": (design, cs.FEATURE_LEN),
                          "feature path": (hm_args, hm_kw["out_len"])},
    }
    live = float(ring_live(pos, stored).sum(1).float().mean())
    print(f"decode_attention inputs: B={b} W={w} nq={nq} nkv={nkv} hd={hd} "
          f"{q.dtype}, {live:.1f} live slots a row; history_merge at the "
          f"feature path: B={hm_args[0].shape[0]}, Lb={hm_args[0].shape[1]}, "
          f"Lr={hm_args[3].shape[1]}, K={hm_kw['out_len']} [{gpu}]")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def timed(fn, cold=False):
        if not cold:
            return cs.device_ms(fn)[0]
        _, per = cs.device_ms(lambda: (flush.zero_(), fn()))
        if not per:  # no kernel named: the flush cannot be told apart
            return float("nan")
        return sum(ms for name, ms in per.items() if "ill" not in name)

    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def call_decode(lib, a):
        fn = lib.decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        out = torch.empty_like(a[0])
        err = fn(*[t.data_ptr() for t in (*a, out)], b, w, nq, nkv, hd,
                 hd ** -0.5, int(q.dtype == torch.bfloat16), dev.index or 0,
                 stream())
        if err:
            raise SystemExit(f"decode_attention launch failed: {err}")
        return out

    def call_merge(lib, a, kk):
        fn = lib.history_merge_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        outs = [torch.empty((a[0].shape[0], kk), dtype=torch.int32,
                            device=dev) for _ in range(3)]
        err = fn(*[t.data_ptr() for t in (*a, *outs)], a[0].shape[0],
                 a[0].shape[1], a[3].shape[1], kk, dev.index or 0, stream())
        if err:
            raise SystemExit(f"history_merge launch failed: {err}")
        return outs

    rows = []
    for key, (label, kernel, name, _) in var.items():
        lib = libs[key]
        for case, a in inputs[kernel].items():
            if kernel == "decode_attention":
                fn = lambda lib=lib, a=a: call_decode(lib, a)  # noqa: E731
                if name == "as it is":
                    err = float((fn().float() - decode_attention_ref(*a)
                                 .float()).abs().max())
                    if err > cs.TOL["bfloat16"]:
                        raise SystemExit(f"{label} {kernel} on {case}: max "
                                         f"abs err {err} vs the plain version")
                ms = {"warm": timed(fn), "cold": timed(fn, cold=True)}
            else:
                fn = lambda lib=lib, a=a: call_merge(lib, *a)  # noqa: E731
                if name == "as it is":
                    for g_, w_ in zip(fn(), history_merge_ref(
                            *a[0], out_len=a[1])):
                        if not torch.equal(g_, w_):
                            raise SystemExit(f"{label} {kernel} on {case}: "
                                             "not bit-equal to the plain "
                                             "version")
                ms = {"warm": timed(fn)}
            rows.append(dict(src=label, kernel=kernel, variant=name,
                             inputs=case, **ms))

    ls = libs["load_store"].ls_launch
    ls.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 \
        + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    es = q.element_size()
    for case, a in inputs["decode_attention"].items():
        o = torch.empty((b, max(nkv * hd * es // 16, 32), 16),
                        dtype=torch.uint8, device=dev)
        kp, vp, pp, sp = (t.data_ptr() for t in (a[1], a[2], a[3], a[4]))
        for which, name, ints in (
                (0, "load/store, every slot's 64-byte piece a (KV head, row)",
                 (b, w, nkv, hd * es // 16)),
                (1, "load/store, live slots' runs a row",
                 (b, w, nkv * hd * es // 16, 0)),
                (2, "load/store, the whole cache streamed",
                 (k.numel() * es // 16, 0, 0, 0))):
            fn = lambda which=which, ints=ints: ls(  # noqa: E731
                which, kp, vp, pp, sp, 0, 0, o.data_ptr(), 0, 0, *ints,
                stream())
            rows.append(dict(src="load/store", kernel="decode_attention",
                             variant=name, inputs=case, warm=timed(fn),
                             cold=timed(fn, cold=True)))
    for case, (a, kk) in inputs["history_merge"].items():
        outs = [torch.empty((a[0].shape[0], kk), dtype=torch.int32,
                            device=dev) for _ in range(3)]
        fn = lambda a=a, kk=kk, outs=outs: ls(  # noqa: E731
            3, *[t.data_ptr() for t in a], *[t.data_ptr() for t in outs],
            a[0].shape[0], a[0].shape[1], a[3].shape[1], kk, stream())
        rows.append(dict(src="load/store", kernel="history_merge",
                         variant="load/store, a row's events and slots",
                         inputs=case, warm=timed(fn)))
    torch.cuda.synchronize()

    for r in rows:
        cold = f"  cold {r['cold']:.4f}" if "cold" in r else ""
        print(f"{r['kernel']:16s} {r['src']:10s} {r['inputs']:12s} "
              f"{r['warm']:.4f} ms{cold}  {r['variant']}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": gpu, "rows": rows}, f, indent=1)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
