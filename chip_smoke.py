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
8. drives the request-level Gateway over the same engine shapes and
   feature plane, four times, from the host prefill-state LRU
   (``ServerConfig(slate_len=10, cache_entries=2048)``) and from the
   paged device state pool (``pool_slots=2048``) in the order LRU, pool,
   pool, LRU: ``warm`` admits 1024 users with fresh events (4 prefill
   panes), a hit wave of the same users must be served every row from
   the cache on the inject path, and a miss wave of 1024 other users on
   the prefill path; each wave's panes are timed by phase (the LRU's host
   copies and concats, or the pool's gather and scatter) and its kernel
   launches counted, and every run's responses must be bit for bit the
   first run's. At fp32 a 64-row Gateway's hit-path first logits must be
   within 1e-4 of the engine's direct prefill -> inject -> decode_slate
   on the same rows and clock, with equal slates (a row that differs
   must be a tie within 1e-4), and bit-equal from the pool; in bf16 the
   differing slates are counted;
9. holds ``ssd_scan`` against its plain version in bf16 and fp32 at the
   prefill and inject shapes of the registered ``mamba2-780m``, with
   padded rows and a random initial state, and at its prefill shape with
   every position live, and checks that bad inputs raise;
10. drives the Mamba2 token path, the same three phases on ``mamba2-780m``
   at full width (48 SSM layers, bf16 weights from a seed) in 4 panes of
   64 users from the same feature plane, counting ``ssd_scan`` launches
   (48 in prefill and 48 in inject a pane), then times the kernel at the
   path's own inputs and at a fully live prefill, and one profiled pane,
   and compares the kernel path with the plain path at fp32 on a pane of
   16 rows (prefill, inject and every teacher-forced decode step's logits
   within 1e-4, equal slates);
11. drives the same full-width ``mamba2-780m`` behind a Gateway that
   serves from a paged state pool of 256 slots (~19.6 GB on the card),
   panes of 64: ``warm`` 256 users, a hit wave of them through inject
   from the pool, a miss wave of 256 others that evicts under slot
   pressure, each timed by phase with its ``ssd_scan`` launches counted;
   the bf16 hit slates must equal the engine's direct prefill -> inject
   -> decode_slate on the same users; the hit wave again and a miss wave
   with the eager slate loop in place of the graph, timed by phase;
12. holds ``decode_slate`` (on the card one replay of a captured CUDA
   graph of the whole greedy slate) bit for bit against its eager loop
   (``_decode_slate_loop``) on an itfi hit pane of 256 rows in bf16 and
   fp32 and a full-width Mamba2 hit pane of 64 rows in bf16, timing both
   in paired runs of alternating order with the capture time, the
   launches a pane and the peak device memory; the itfi Gateway runs
   above include two pooled runs with the loop, whose responses must be
   bit for bit the graph's;
13. sampled decode (``ServingEngine.sample`` at temperature 0.8): equal to
   ``argmax(noise + logits / T)`` for a given noise, and a chi-square
   test of 2e5 draws from the card's generator on one row against
   ``softmax(logits / T)``;
14. the online trainer on the full-width ``itfi-ranker`` over the feature
   plane's event log with fresh events appended: a few steps by hand,
   a full patch and then an ``("embed",)`` delta patch, each through its
   bytes and ``Gateway.install_patch`` into a pooled Gateway whose slate
   graph is warm; each following wave must be bit for bit what a cold
   pooled Gateway built from the trainer's weights serves;
15. the trainer's background worker attached to that Gateway while it
   serves waves that capture new slate graphs: patches land between
   panes, each pane serves one model version;
16. ``save_checkpoint``/``load_checkpoint`` of the trained full-width
   params with the port's pure-Python msgpack codec: every leaf, bf16
   included, bit for bit;
17. the paper's §IV A/B experiment, ``core.ab.run_experiment`` on the
   full-width ``itfi-ranker`` (800 users, 4864 items, days 4 + 4 + 6,
   arms control, treatment, consistent and ``stale_3600s``): every arm
   faces identical impressions, every CTR is in (0, 0.9) and every lift
   inside its CI; ``flash_attention`` launches in gen 1 and every arm,
   ``history_merge`` in the treatment alone; the treatment's first A/B
   day rerun from the same world and params is bit for bit the first
   run's; one serve call of 256 users in each mode (inject, batch,
   consistent, staleness 3600) with the gen-2 params in fp32, kernel
   path against plain path (equal tokens, logits within 1e-4, a slate
   may differ only on a row whose top scores tie within 1e-4); both
   kernels held against and timed beside their plain versions at the
   experiment's own inputs; each ``train_ranker``, ``simulate_day`` and
   serve call timed;
18. the scenario harness (``serving/loadgen.py``) through the Gateway:
   (a) ``run_scenario`` of every named scenario at the harness's own
   fp32 engines (a 2-layer, 64-wide ranker; ``mixed_fleet`` on reduced
   ``llama3.2-1b``, ``mamba2-780m`` and ``granite-moe-3b-a800m``): every
   trace fingerprint, and every sim-time metric and gateway counter the
   reference still reproduces (``RECORD_*``), must equal the JAX
   package's record in ``BENCH_scenarios.json`` (read as data), and
   every SLO gate, the wall-clock budgets included, must pass; (b)
   ``churn_heavy`` at smoke size, fp32, through the kernel path and the
   plain path (equal slates but on rows whose top first-logit scores tie
   within 1e-4, which are counted; scores within 1e-4), and the kernel
   path again, bit for bit the first; (c) at full width with bf16 weights
   from the seed, the four single-arch scenarios on ``itfi-ranker`` and
   ``mixed_fleet`` on ``llama3.2-1b``, ``mamba2-780m`` and
   ``granite-moe-3b-a800m`` (one at a time, each freed before the next),
   each through ``build_gateway(spec, engine=...)``: trace fingerprints
   and sim-time counters must equal the record, and a second
   ``churn_heavy`` replay must serve bit for bit the first. The harness's
   wall-clock budgets were calibrated on the tiny models on a CPU host,
   so at full width they are printed with budget and actual, not
   asserted. Each replay prints its seconds, requests/s, ``wall_ms_p99``
   by path group and its kernel launches;
19. the modality-frontend archs at full width through the one-device step
   layer (``launch/steps.py``), after freeing what the earlier phases
   hold (``torch.cuda.mem_get_info()`` printed, the peak memory after
   each step): (a) ``musicgen-large`` (48 layers, d 2048, bf16 from the
   seed): ``prefill_32k`` at local batch 2 (64 audio prefix embeddings +
   32704 tokens), ``decode_32k`` (a 32768-slot ring from that prefill,
   8 greedy ``make_serve_step`` steps, run twice from the same prefill:
   bit for bit the same tokens), ``long_500k`` (the 4096-position window
   ``arch_for_shape`` substitutes, prefilled at positions 520192...524287,
   8 steps from 524288), a bf16 prefill at S = 2048 with kernels against
   ``use_kernels=False`` (last logits within 5% of the largest plain
   logit, greedy tokens equal but where the plain top two are that
   close), and ``train_4k``, 2 donating train steps at batch 1 x 4096
   (64 prefix positions out of the loss; finite loss, params moved in
   their own tensors); (b) ``llava-next-34b`` (60 layers, d 7168, 34.4 B
   params, bf16) initialised on the card, one image request (2880 patch
   embeddings + 2880 text tokens) prefilled, its ring built and 4 greedy
   steps. Every run's inputs have the shapes and dtypes of the step
   layer's example args; each kernel's layer-0 inputs, recorded from
   those runs, are held against the plain versions (``flash_attention``
   over every query row, in chunks) and timed beside SDPA and the bound;
20. the device mesh: (a) right after phase 8, the itfi Gateway at full
   width (panes of 256, bf16, 512 users a wave) on a 1x1 NCCL mesh in
   this process, from the host LRU and then the pool, against the
   mesh-free Gateway: every response bit for bit and every counter
   equal; (b) last, with four cards (``torch.cuda.device_count()``), one
   process a card: the itfi Gateway in fp32 and bf16 on 1x1, 4x1 and 2x2
   meshes (fp32 scores within 1e-4 of 1x1's, a slate may differ only on a
   row whose picks tie within 1e-4; bf16 timed by phase and by
   collective), then ``jamba-v0.1-52b`` at full width on 1x4 (sharded
   bf16 init from the seed, panes of 64 through prefill, inject and
   ``decode_slate``, timed by phase with the peak memory of each rank,
   and rank 0's layer inputs of the three kernels held against the plain
   versions). With one card (b) prints one line saying it did not run.
   ``--mesh-only`` runs phase 20 alone, and no result line;
21. the step layer on a mesh (``launch/steps.py``'s
   ``make_step_and_specs``): (a) after phase 19, full-width
   ``llama3.2-1b`` (bf16 from the seed) on a 1x1 NCCL mesh in this
   process, each step kind against ``make_step_and_inputs``' one-device
   step from the same seed on its own copy: two donating ``train_4k``
   steps at local batch 1 (every metric and every updated leaf bit for
   bit), a prefill at S 4096 and a ``decode_32k`` step at batch 1 (every
   output bit for bit), each timed with the peak memory; (b) last, with
   four cards, one process a card: ``llama3.2-1b`` in fp32 on 2x2, 1x4
   and 4x1, one ``train_4k`` step at a global batch of 4 against the
   mesh-free step on each rank's card (loss and grad norm within 1e-4
   relative, every rank's blocks of the updated params and of m within
   1e-4 at AdamW eps 1e-3), then ``codeqwen1.5-7b`` at full width (bf16
   from the seed; FSDP 2 x TP 2) on 2x2: three ``train_4k`` steps at a
   global batch of 2 (losses finite and equal on every rank, ms a step,
   peak memory a rank), a prefill at S 4096 and two ``decode_32k``
   steps at batch 2, rank 0's layer-0 kernel inputs held against the
   plain versions. With one card (b) prints one line saying it did not
   run. ``--steps-mesh-only`` runs phase 21 alone, and no result line;
22. the dry run against the card (``launch/dryrun.py``: each step run
   once on meta tensors under ``launch/op_analysis.py``): (a) after
   phase 21 (a), full-width ``llama3.2-1b`` (bf16 from the seed) on a
   1x1 NCCL mesh: a ``train_4k`` step, a prefill at S 4096 and a
   ``decode_32k`` step, each at batch 1, first dry-run on meta at
   exactly those arguments and then run on the card from fresh
   arguments, its measured peak held to within 0.85-1.15x of the dry
   run's estimate, and its ms beside the roofline's three terms and
   model FLOPs over (s x peak); (b) last, with four cards, one process a
   card: ``deepseek-67b``, ``command-r-plus-104b`` and ``mixtral-8x22b``
   at full width (bf16) on 1x4: their ``train_4k`` step at batch 1
   dry-run only and refused as not fitting, a prefill at S 4096 and a
   ``decode_32k`` step at batch 1 dry-run and then run (a step the dry
   run says does not fit is printed and not run), each rank's peak held
   to the same band, the next tokens equal on the four ranks, layer 0's
   kernel inputs against the plain versions, and each collective's share
   of a second, collective-timed call. ``--dryrun-only`` runs phase 22
   alone, and no result line.

It needs a CUDA device: without one it exits non-zero and prints no result.
The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
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
# the Gateway phase: users a wave, the host LRU's entry budget (the pool's
# slots), fp32 pane
GW_USERS, GW_CACHE_ENTRIES, GW_FP32_ROWS = 1024, 2048, 64
# the pooled Mamba2 Gateway: users a wave, slots (256 x ~77 MB = ~19.6 GB)
MAMBA_GW_USERS, MAMBA_POOL_SLOTS = 256, 256
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int32": 67e12}
TOL = {"bfloat16": 3e-2, "float32": 2e-5}    # as tests/test_kernels.py
E2E_TOL = 1e-4
# decode_slate's graph against its loop: paired runs, alternating order
GRAPH_PAIRS = 10
# ... and the slate lengths of the graphs captured after it, each over the
# same ring buffers
GRAPH_MORE_LENS = (3, 5, 7)
# sampled decode: temperature, draws of the chi-square test (in batches)
SAMPLE_T, SAMPLE_DRAWS, SAMPLE_BATCH = 0.8, 200_000, 10_000
# the online trainer: its batch and window, the users of the served wave
TRAIN_BATCH, TRAIN_SEQ, TRAIN_USERS = 256, 256, 512
# the A/B experiment: ABConfig's world of 800 users (its items are the
# ranker's catalog, vocab - 256), and the users of the fp32 serve call
AB_USERS, AB_FP32_USERS = 800, 256
# the scenario harness: the single-arch scenarios' full-width model, the
# kernels its replays launch, and the fields held against the JAX
# package's record. The record predates the reference's handoff
# retention: its rollover "invalidated" and cache counters are not what
# the JAX package gives today (tests/test_torch_scenarios_fleet.py holds
# the port to today's), so they are printed, not compared.
SCENARIO_WIDE = "itfi-ranker"
SCENARIO_KERNELS = ("flash_attention", "decode_attention", "ssd_scan")
RECORD_METRICS = ("requests", "served", "shed", "deadline_misses",
                  "hit_rate", "queue_delay", "paths")
RECORD_COUNTERS = ("requests", "panes", "prefill_calls", "inject_calls",
                   "decode_steps", "deadline_flushes", "shed",
                   "deadline_misses", "paths", "queue_delay")
RECORD_ROLLOVER = ("rollovers", "rekeyed", "rebuilt", "build_steps",
                   "pending_build_users", "pending_rewarm")
# the frontend archs: musicgen's local batch for prefill_32k and
# decode_32k, greedy steps a decode run, train steps; the sequence of the
# bf16 kernel-against-plain prefill and its tolerance (a share of the
# largest plain logit); query rows a plain attention call in the checks;
# llava's image request (2880 patches + 2880 text tokens) and its steps
FRONTEND_KERNELS = ("flash_attention", "decode_attention")
FRONTEND_PREFILL_BATCH, FRONTEND_MG_STEPS, FRONTEND_TRAIN_STEPS = 2, 8, 2
FRONTEND_CHECK_SEQ, FRONTEND_BF16_REL_TOL = 2048, 0.05
FRONTEND_ROW_CHUNK = 256
# phase 19's kernel-against-plain limits, scaled to the plain output: at
# long context a row's output is small (about sqrt(e/n) over n live keys,
# 0.009 at 32768), so TOL's absolute limit alone would pass a zero output.
# Per call (decode) or chunk of query rows (flash): max |got - want| at most
# 2^-4 of max |want| (8 bf16 ulps of the largest value) and
# ||got - want|| / ||want|| at most 1e-2; TOL still holds as well
FRONTEND_REL_MAX_TOL, FRONTEND_REL_RMS_TOL = 2.0 ** -4, 1e-2
LLAVA_SEQ, LLAVA_STEPS = 5760, 4
# phase 20, the mesh: users a wave of its itfi Gateways, their backends
# and kernels; the multi-card meshes held against 1x1; jamba's mesh, its
# pane of 64 rows (its weights are 25.8 GB a rank at 1x4, its f32 SSM
# state 28 layers x 32 local heads x 64 x 128 x 4 B = 29 MB a row), the
# timed panes and its kernels
MESH_USERS = 512
MESH_BACKENDS = ("host LRU", "pool")
MESH_KERNELS = ("flash_attention", "decode_attention")
MESH_SHAPES = ((4, 1), (2, 2))
JAMBA_ARCH, JAMBA_MESH, JAMBA_BATCH = "jamba-v0.1-52b", (1, 4), 64
JAMBA_PANES = 2
JAMBA_KERNELS = ("flash_attention", "decode_attention", "ssd_scan")
# phase 21, the step layer on a mesh: (a) the full-width arch, its train
# steps and its prefill's sequence on a 1x1 mesh; (b) the fp32 meshes held
# against the mesh-free step and their global batch, then the arch that
# trains only across cards, its mesh, global batch and steps
STEPS_ARCH, STEPS_TRAIN_STEPS, STEPS_PREFILL_SEQ = "llama3.2-1b", 2, 4096
STEPS_KERNELS = ("flash_attention", "decode_attention")
STEPS_MESHES, STEPS_CARDS_BATCH = ((2, 2), (1, 4), (4, 1)), 4
# (b)'s fp32 meshes: each rank's blocks of the updated params to within
# STEPS_PARAM_TOL, and of m to within STEPS_M_REL_TOL of each leaf's
# largest |m| (a first AdamW step at lr 1e-3 and eps 1e-3 moves a param by
# about its gradient, ~1e-4; m is a tenth of the gradient)
STEPS_PARAM_TOL, STEPS_M_REL_TOL = 1e-6, 1e-4
STEPS_BIG_ARCH, STEPS_BIG_MESH, STEPS_BIG_BATCH = ("codeqwen1.5-7b", (2, 2),
                                                   2)
STEPS_BIG_TRAIN_STEPS, STEPS_BIG_DECODE_STEPS = 3, 2
# phase 22, the dry run against the card: (a) phase 21 (a)'s arch and
# shapes at batch 1 on a 1x1 mesh; (b) the archs that need four cards, on
# 1x4 at batch 1 (their train_4k step is dry-run only and must not fit);
# the band that a measured peak must fall in, as a share of the dry run's
# estimate
DRYRUN_KINDS = ("train", "prefill", "decode")
DRYRUN_CARDS_ARCHS = ("deepseek-67b", "command-r-plus-104b", "mixtral-8x22b")
DRYRUN_CARDS_MESH = (1, 4)
DRYRUN_PEAK_BAND = (0.85, 1.15)


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

    report["history_merge"] = dict(
        name="history_merge", route="cuda",
        source="src/repro_torch/kernels/history_merge/csrc/history_merge.cu",
        replaces="src/repro/kernels/history_merge/history_merge.py:68",
        max_abs_err=float(err), library_ms=None,
        **time_merge(design, k, "the design point", gpu))


def time_merge(args, out_len, label, gpu):
    """The kernel and its plain version on the same inputs; returns the
    measured times and the bound of these inputs."""
    from repro_torch.kernels.history_merge.ops import history_merge
    from repro_torch.kernels.history_merge.ref import history_merge_ref
    b, lb, lr = args[0].shape[0], args[0].shape[1], args[3].shape[1]
    call_ms = time_ms(lambda: history_merge(*args, out_len=out_len))
    ms, _ = device_ms(lambda: history_merge(*args, out_len=out_len))
    plain_ms, _ = device_ms(lambda: history_merge_ref(*args, out_len=out_len),
                            5, 1)
    n = lb + lr
    n_bytes = 4 * 3 * b * (lb + lr + out_len)
    n_ops = b * n * math.log2(n)  # a comparison sort's least work per row
    bound_ms, bound_by = bound(n_bytes, n_ops, "int32")
    print(f"time history_merge at {label} (B={b}, Lb={lb}, Lr={lr}, "
          f"K={out_len}): kernel {ms:.4f} ms on the device ({call_ms:.4f} ms "
          f"per wrapper call, CUDA events), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}) [{gpu}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


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
    from repro_torch.core import PipelineConfig, RecommenderPlatform

    inj, pop, rng = build_feature_plane(dev, cfg)
    plat = RecommenderPlatform(
        PipelineConfig(n_items=cfg.vocab_size - 256, serve_batch=SERVE_BATCH),
        cfg, params, inj, pop, device=dev)
    return plat, rng


def build_feature_plane(dev, cfg):
    """The feature plane's injector over N_USERS users and N_EVENTS events
    from SEED, the items' popularity, and the generator after them."""
    from repro_torch.core import (BatchFeatureStore, FeatureInjector,
                                  FeatureStoreConfig, InjectionConfig,
                                  RealtimeConfig, RealtimeFeatureService)

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
    print(f"feature plane: {N_USERS} users, {N_EVENTS} events, snapshot at "
          f"day 30, {N_FRESH} fresh events after it; built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    return inj, pop / pop.sum(), rng


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


def top_score_gap(last, cand, slate_size):
    """Per row, the smallest gap between neighbours among its top
    slate_size + 1 candidate scores (the slate and the first one left
    out), duplicate candidates masked as the serve core masks them: a
    row whose gap is within E2E_TOL may rank differently by rounding."""
    import torch
    c = cand.shape[1]
    dup = ((cand[:, :, None] == cand[:, None, :]) & torch.ones(
        c, c, dtype=torch.bool, device=cand.device).tril(-1)).any(-1)
    scores = torch.gather(last, 1, cand + 1).masked_fill(dup, -1e9)
    top = scores.sort(1, descending=True).values[:, :slate_size + 1]
    return (top[:, :-1] - top[:, 1:]).min(1).values


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
    gap = top_score_gap(p_last, cand, pcfg.slate_size)
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
        # the eager loop: a graph captured under these patches would keep
        # the plain versions for every later replay
        p_slate = eng._decode_slate_loop(p_state, p_state["first_logits"],
                                         SLATE_LEN)
        p_picks, p_logits, gaps = steps(p_state)
    if not np.array_equal(torch.stack(p_picks, 1).cpu().numpy(), p_slate):
        raise SystemExit("the plain path's step loop and _decode_slate_loop "
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


def graph_vs_loop(eng, state, label, gpu, pairs=GRAPH_PAIRS):
    """``decode_slate`` (the captured graph) against ``_decode_slate_loop``
    on one pane's inject state: the capture (first call), then ``pairs``
    paired runs in alternating order, every slate bit for bit the loop's;
    host-clock ms of each (the slate's copy to the host ends both), the
    launches a pane (the graph's captured launches, counted at each
    replay, against the loop's, and against the kernels a profiler trace
    of one replay holds) and the peak device memory. Then the graphs of
    GRAPH_MORE_LENS slate lengths, captured over the same ring buffers:
    their slates are the first picks of the loop's (greedy decode is
    prefix-stable), and neither the device memory in use nor its peak
    may grow by an eighth of the ring buffers' bytes (one more copy of
    the rings per length is the fault this rules out)."""
    import torch
    from repro_torch.kernels import launch_counters

    first = state["first_logits"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = eng._decode_slate_loop(state, first, SLATE_LEN)
    if not np.array_equal(eng.decode_slate(state, first, SLATE_LEN), want):
        raise SystemExit(f"slate graph {label}: the capture call's slate "
                         f"differs from the eager loop's")
    stats = eng.slate_graph_stats()[(SLATE_LEN, tuple(first.shape))]
    fns = {"graph": lambda: eng.decode_slate(state, first, SLATE_LEN),
           "loop": lambda: eng._decode_slate_loop(state, first, SLATE_LEN)}
    ops = launch_counters()
    launches = {}
    for name, fn in fns.items():
        before = {n: op.launches for n, op in ops.items()}
        fn()
        launches[name] = {n: op.launches - before[n] for n, op in ops.items()
                          if op.launches != before[n]}
    if not launches["graph"] == launches["loop"] == stats.launches:
        raise SystemExit(f"slate graph {label}: launches a pane, graph "
                         f"{launches['graph']}, loop {launches['loop']}, "
                         f"captured {stats.launches}")
    traced = replay_kernels(fns["graph"], stats.launches)
    if traced != stats.launches:
        raise SystemExit(f"slate graph {label}: a traced replay ran the "
                         f"kernels {traced}, the capture recorded "
                         f"{stats.launches}")
    ms = {"graph": [], "loop": []}
    for i in range(pairs):
        for name in (("graph", "loop") if i % 2 == 0 else ("loop", "graph")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fns[name]()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(out, want):
                raise SystemExit(f"slate graph {label}: a {name} slate "
                                 f"differs from the first loop's")
    g, lp = np.array(ms["graph"]), np.array(ms["loop"])
    wins = int((g < lp).sum())
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"slate graph {label}: capture (warm-up run and capture; the "
          f"ring buffers come from the pane shape's first finalize) "
          f"{stats.capture_ms:.2f} ms; decode_slate({SLATE_LEN}) graph "
          f"median {np.median(g):.3f} ms (min {g.min():.3f}, max "
          f"{g.max():.3f}), loop median {np.median(lp):.3f} ms (min "
          f"{lp.min():.3f}, max {lp.max():.3f}) over {pairs} paired runs in "
          f"alternating order (host clock, synchronised); graph faster in "
          f"{wins} of {pairs} pairs; every slate bit for bit the loop's; "
          f"launches a pane {stats.launches} (captured x 1 replay, as the "
          f"loop's and as a profiler trace of one replay holds); ring "
          f"buffers {stats.ring_bytes / 1e9:.3f} GB; peak device memory "
          f"{peak:.2f} GB [{gpu}]")
    print(f"slate graph {label} ms graph {[round(float(x), 3) for x in g]} "
          f"loop {[round(float(x), 3) for x in lp]}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns["graph"]()
    base_now = torch.cuda.memory_allocated()
    base_peak = torch.cuda.max_memory_allocated()
    graphs0 = len(eng.slate_graph_stats())
    capture_ms = []
    for n in GRAPH_MORE_LENS:
        got = eng.decode_slate(state, first, n)
        if not np.array_equal(got, want[:, :n]):
            raise SystemExit(f"slate graph {label}: the {n}-slate is not "
                             f"the first {n} picks of the loop's")
        capture_ms.append(
            eng.slate_graph_stats()[(n, tuple(first.shape))].capture_ms)
    grow_now = torch.cuda.memory_allocated() - base_now
    grow_peak = torch.cuda.max_memory_allocated() - base_peak
    limit = stats.ring_bytes // 8
    print(f"slate graph {label}: {len(eng.slate_graph_stats()) - graphs0} "
          f"more graphs (slate lengths {list(GRAPH_MORE_LENS)}, captures "
          f"{[round(x, 2) for x in capture_ms]} ms) over the same ring "
          f"buffers: device memory in use grew {grow_now} bytes, its peak "
          f"{grow_peak} bytes over a replay's (limit {limit} bytes each, an"
          f" eighth of the rings) [{gpu}]")
    if len(eng.slate_graph_stats()) - graphs0 != len(GRAPH_MORE_LENS) \
            or grow_now >= limit or grow_peak >= limit:
        raise SystemExit(f"slate graph {label}: a new slate length took "
                         f"more device memory than the limit")
    return {"graph_ms": g, "loop_ms": lp}


def replay_kernels(fn, names, tries=3):
    """{name: launches} of the kernels ``names`` in a profiler trace of
    one ``fn()`` (a graph replay): the events named ``<name>_kernel``. A
    trace that holds no device time (the profiler now and then returns
    one) is taken again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if _device_us(e) > 0]
        if evts:
            return {n: k for n, k in (
                (n, sum(e.count for e in evts if f"{n}_kernel" in e.key))
                for n in names) if k}
    raise SystemExit("the profiler recorded no device time in "
                     f"{tries} traces of a slate replay")


def run_slate_graph(dev, gpu, plat, params, now):
    """The itfi graph-vs-loop phase on a hit pane of 256 fresh users (the
    state a pooled hit pane hands ``decode_slate``: prefill, then inject
    of the fresh suffix), in bf16 and in fp32."""
    import torch
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = plat.model_cfg
    users = fresh_users(plat.injector, now, np.random.RandomState(SEED + 6),
                        SERVE_BATCH)
    scfg = ServingConfig(max_batch=SERVE_BATCH, prefill_len=PANE_PREFILL,
                         inject_len=PANE_INJECT, cache_capacity=PANE_CAPACITY)
    fp32 = init_params(cfg, torch.Generator().manual_seed(SEED),
                       torch.float32, dev)
    for dtype, p in (("bf16", params), ("fp32", fp32)):
        eng = ServingEngine(cfg, p, scfg, device=dev)
        hist, sfx = pane_inputs(eng, plat.injector, users, now)
        pre = eng.prefill(*hist)
        state = eng.inject(pre, *sfx, fallback_logits=pre["logits"][:, -1])
        del pre
        graph_vs_loop(eng, state, f"itfi {dtype} hit pane of {SERVE_BATCH}",
                      gpu)
        del eng, state
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# The Gateway: warm, a hit wave from the host LRU, a miss wave
# ----------------------------------------------------------------------

class PhaseClock:
    """Host-clock ms of wrapped calls by phase, each call starting and
    ending in a device synchronise (``sync``); a call made inside another
    call of the same phase counts once, in the outer one."""

    def __init__(self):
        self.ms, self.calls, self._depth = {}, {}, {}

    def wrap(self, phase, fn, sync=True):
        import torch

        def timed(*args, **kwargs):
            depth = self._depth.get(phase, 0)
            if depth:
                return fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._depth[phase] = 1
            try:
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
            finally:
                self._depth[phase] = 0
            self.ms[phase] = self.ms.get(phase, 0.0) + \
                (time.perf_counter() - t0) * 1e3
            self.calls[phase] = self.calls.get(phase, 0) + 1
            return out
        return timed

    def patches(self, gw):
        """The patches that time a Gateway's phases: pane assembly (host
        concats and host->device copies, or the pool's gather), the
        engine's prefill, inject and decode_slate, the device->host copy
        of a prefill state and the slicing of its rows into LRU entries,
        or the pool's scatter."""
        from repro_torch.serving import scheduler as scheduler_mod
        eng = gw.engine
        pool = [] if gw.pool is None else [
            mock.patch.object(gw.pool, "gather",
                              self.wrap("pool gather", gw.pool.gather)),
            mock.patch.object(gw.pool, "scatter",
                              self.wrap("pool scatter", gw.pool.scatter)),
        ]
        return pool + [
            mock.patch.object(scheduler_mod, "_cat_rows",
                              self.wrap("assembly", scheduler_mod._cat_rows)),
            mock.patch.object(scheduler_mod, "_join",
                              self.wrap("assembly", scheduler_mod._join)),
            mock.patch.object(scheduler_mod, "_host_state", self.wrap(
                "host copy", scheduler_mod._host_state)),
            mock.patch.object(scheduler_mod, "_slice_row", self.wrap(
                "row slicing", scheduler_mod._slice_row, sync=False)),
            mock.patch.object(eng, "prefill", self.wrap("prefill",
                                                        eng.prefill)),
            mock.patch.object(eng, "inject", self.wrap("inject", eng.inject)),
            mock.patch.object(eng, "decode_slate",
                              self.wrap("decode_slate", eng.decode_slate)),
        ]


def fresh_users(injector, now, rng, n, exclude=()):
    """``n`` users, in a seeded order, whose realtime buffer holds events
    after the serving snapshot (each has a fresh suffix to inject)."""
    cand = rng.permutation(N_USERS)
    cand = cand[~np.isin(cand, np.asarray(exclude, np.int64))][:3 * n]
    sfx = injector.fresh_suffix_tokens(cand, now, cap=PANE_INJECT)
    keep = cand[[len(x) > 0 for x in sfx]][:n]
    if len(keep) < n:
        raise SystemExit(f"only {len(keep)} of {n} users have fresh events")
    return keep


def kernel_ops(names):
    """{name: the kernel's wrapper} for the launch counters."""
    from repro_torch.kernels import launch_counters
    ops = launch_counters()
    return {n: ops[n] for n in names}


def gateway_wave(gw, users, now, label, gpu, clock=None,
                 kernels=("flash_attention", "decode_attention")):
    """``submit_many`` + ``flush`` of ``users`` at ``now``; returns the
    tickets, the wave's launches of ``kernels``, its host-clock seconds
    (ending in a device synchronise) and the cache counters' change."""
    import torch
    from repro_torch.serving import Request

    ops = kernel_ops(kernels)
    c0 = dict(gw.cache.stats())
    with contextlib.ExitStack() as stack:
        for patch in (clock.patches(gw) if clock is not None else []):
            stack.enter_context(patch)
        torch.cuda.synchronize()
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        tickets = gw.submit_many([Request(user=int(u), now=now)
                                  for u in users])
        gw.flush(now)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {n: op.launches for n, op in ops.items()}
    c1 = gw.cache.stats()
    delta = {k: c1[k] - c0[k] for k in ("hits", "misses", "evictions")}
    panes = -(-len(users) // gw.engine.scfg.max_batch)
    print(f"gateway {label} wave: {len(users)} requests in {panes} panes of "
          f"{gw.engine.scfg.max_batch}, {elapsed / panes * 1e3:.2f} ms per "
          f"pane, {len(users) / elapsed:.1f} requests/s (host clock, ending "
          f"in a device synchronise{', phases timed' if clock else ''}); "
          f"cache {delta}; launches {launches} [{gpu}]")
    if clock is not None:
        other = elapsed * 1e3 - sum(clock.ms.values())
        print(f"gateway {label} wave ms per pane by phase: " + ", ".join(
            f"{k} {v / panes:.3f}" for k, v in clock.ms.items())
            + f", the rest of the host (features, suffixes, "
            f"{'slot table' if gw.pool is not None else 'LRU'}, telemetry) "
            f"{other / panes:.3f} (host clock, synchronised) [{gpu}]")
    return tickets, launches, elapsed, delta


def gateway_warm(gw, users, now, label, gpu, kernels):
    """``gw.warm(users, now)`` timed by phase; returns its launches of
    ``kernels``, the first of which prefill must launch."""
    import torch

    ops = kernel_ops(kernels)
    clock = PhaseClock()
    with contextlib.ExitStack() as stack:
        for patch in clock.patches(gw):
            stack.enter_context(patch)
        torch.cuda.synchronize()
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        warmed = gw.warm(users, now)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    launches = {n: op.launches for n, op in ops.items()}
    panes = -(-len(users) // gw.engine.scfg.max_batch)
    where = (f"pool {gw.pool.n_slots} slots, "
             f"{gw.pool.n_slots * gw.pool.slot_nbytes / 1e9:.3f} GB on the "
             f"card, {len(gw.cache)} entries" if gw.pool is not None else
             f"LRU {len(gw.cache)} entries, "
             f"{gw.cache.bytes_per_shard / 1e9:.3f} GB on the host")
    print(f"gateway {label} warm: {warmed} states admitted in "
          f"{gw.stats().prefill_calls} prefill panes, "
          f"{warm_s / panes * 1e3:.2f} ms per pane (host clock); by phase "
          f"per pane: " + ", ".join(f"{k} {v / panes:.3f}"
                                    for k, v in clock.ms.items())
          + f"; {where} ({gw.cache.bytes_per_shard / len(gw.cache) / 1e6:.3f}"
          f" MB an entry); launches {launches} [{gpu}]")
    prefill_kernel = kernels[0]
    if warmed != len(users) or launches[prefill_kernel] <= 0:
        raise SystemExit(f"gateway {label} warm: {warmed} admitted, "
                         f"launches {launches}")
    return launches


def check_gateway_slates(tickets, vocab, label):
    for t in tickets:
        s = t.response.slate
        if s.shape != (SLATE_LEN,) or s.min() < 0 or s.max() >= vocab \
                or len(set(s.tolist())) != SLATE_LEN:
            raise SystemExit(f"gateway {label}: bad slate {s.tolist()}")
        if not np.isfinite(t.response.scores[:vocab]).all():
            raise SystemExit(f"gateway {label}: non-finite scores")


def pick_gaps(eng, state, slate_len=SLATE_LEN):
    """Greedy picks from an inject state and, per row and pick, the gap
    between the best and the second-best remaining logit."""
    import torch
    from repro_torch.serving.engine import NEG_INF
    dec = eng.finalize(state)
    logits = state["first_logits"]
    mask = torch.zeros_like(logits, dtype=torch.bool)
    rows = torch.arange(logits.shape[0], device=logits.device)
    gaps = []
    for i in range(slate_len):
        masked = torch.where(mask, NEG_INF, logits)
        top2 = masked.topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        tok = masked.argmax(-1).to(torch.int32)
        mask[rows, tok.long()] = True
        if i < slate_len - 1:
            logits, dec = eng.decode(dec, tok[:, None])
    return torch.stack(gaps, 1)


def compare_gateway_fp32(dev, cfg, injector, users, now, pool=False):
    """A 64-row fp32 Gateway's hit path against the engine's direct
    prefill -> inject -> decode_slate on the same rows and clock: first
    logits within 1e-4, equal slates except on a row whose picks tie
    within 1e-4. With ``pool`` the Gateway serves from the paged state
    pool and must be bit-equal: 0 error and 0 slates differing."""
    import torch
    from repro_torch.models.model import init_params
    from repro_torch.serving import (Gateway, Request, ServingConfig,
                                     ServingEngine)

    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         torch.float32, dev)
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=GW_FP32_ROWS, prefill_len=PANE_PREFILL,
        inject_len=PANE_INJECT, cache_capacity=PANE_CAPACITY), device=dev)
    gw = Gateway(eng, injector, gateway_config(
        "pool" if pool else "host LRU", GW_FP32_ROWS))
    label = "pooled" if pool else "host-LRU"
    users = users[:GW_FP32_ROWS]
    gw.warm(users, now)
    tickets = gw.submit_many([Request(user=int(u), now=now) for u in users])
    gw.flush(now)
    if any(t.response.telemetry.path != "inject" for t in tickets):
        raise SystemExit(f"fp32 {label} gateway: a warmed row left the "
                         f"inject path")
    state, slate = serve_pane(eng, *pane_inputs(eng, injector, users, now))
    want = state["first_logits"]
    got = torch.from_numpy(np.stack([t.response.scores for t in tickets]))
    got_slate = np.stack([t.response.slate for t in tickets])
    err = float((got.to(dev) - want).abs().max())
    torch.testing.assert_close(got.to(dev), want, atol=E2E_TOL, rtol=E2E_TOL)
    flipped = np.flatnonzero((got_slate != slate).any(1))
    gaps = pick_gaps(eng, state)[torch.as_tensor(flipped, device=dev)]
    min_gap = gaps.min(1).values.tolist() if len(flipped) else []
    print(f"fp32 {label} gateway hit path vs the engine's prefill -> inject "
          f"-> decode_slate, {len(users)} rows: first logits max abs err "
          f"{err:.3g} (tolerance {0 if pool else E2E_TOL}), {len(flipped)} "
          f"slates differ; smallest top-2 gap of each differing row: "
          f"{[f'{x:.3g}' for x in min_gap]}")
    if pool and (err != 0 or len(flipped)):
        raise SystemExit("fp32 pooled gateway: the hit path is not "
                         "bit-equal to the engine's direct path")
    if any(g > E2E_TOL for g in min_gap):
        raise SystemExit("fp32 gateway: a slate differs on a row whose "
                         "picks are separated by more than the tolerance")


# "pool loop": the pool with the eager slate loop in place of the graph
GW_BACKENDS = ("host LRU", "pool", "pool loop", "pool loop", "pool",
               "host LRU")


def gateway_config(backend, entries):
    """``ServerConfig`` of a Gateway that caches ``entries`` prefill
    states in the host LRU or (``backend`` "pool" or "pool loop") the
    state pool."""
    from repro_torch.serving import ServerConfig
    budget = ({"pool_slots": entries} if backend.startswith("pool")
              else {"cache_entries": entries})
    return ServerConfig(slate_len=SLATE_LEN, **budget)


def slate_loop(eng, on=True):
    """A context in which ``eng.decode_slate`` is its eager loop (``on``),
    or nothing changes."""
    if not on:
        return contextlib.nullcontext()
    return mock.patch.object(eng, "decode_slate", eng._decode_slate_loop)


def gateway_backend(eng, injector, backend, hit_users, miss_users, now,
                    gpu):
    """One Gateway over ``eng`` from ``backend`` ("host LRU" or "pool",
    each with GW_CACHE_ENTRIES entries): warm the hit users, a hit wave
    that must be all hits on the inject path, the same wave again, and a
    miss wave that must be all prefills. Returns (hit tickets, miss
    tickets, the launches of the timed warm, hit and miss). A "pool loop"
    backend serves with the eager slate loop."""
    with slate_loop(eng, backend.endswith("loop")):
        return _gateway_backend(eng, injector, backend, hit_users,
                                miss_users, now, gpu)


def _gateway_backend(eng, injector, backend, hit_users, miss_users, now,
                     gpu):
    import torch
    from repro_torch.serving import Gateway

    gw = Gateway(eng, injector, gateway_config(backend, GW_CACHE_ENTRIES))
    kernels = ("flash_attention", "decode_attention")
    launches = gateway_warm(gw, hit_users, now, backend, gpu, kernels)
    hit, hit_launches, _, hit_delta = gateway_wave(
        gw, hit_users, now, f"{backend} hit", gpu, clock=PhaseClock())
    paths = {t.response.telemetry.path for t in hit}
    st = gw.stats()
    print(f"gateway {backend} hit wave: hit rate "
          f"{hit_delta['hits'] / len(hit_users):.3f}, paths {sorted(paths)}; "
          f"stats paths {st.paths}, prefill_calls {st.prefill_calls}, "
          f"inject_calls {st.inject_calls}")
    if hit_delta["hits"] != len(hit_users) or paths != {"inject"} \
            or not all(t.response.telemetry.cache_hit for t in hit):
        raise SystemExit(f"gateway {backend} hit wave: a row was not a hit "
                         f"on the inject path")
    gateway_wave(gw, hit_users, now, f"{backend} hit (again)", gpu)
    miss, miss_launches, _, miss_delta = gateway_wave(
        gw, miss_users, now, f"{backend} miss", gpu, clock=PhaseClock())
    paths = {t.response.telemetry.path for t in miss}
    print(f"gateway {backend} miss wave: hit rate "
          f"{miss_delta['hits'] / len(miss_users):.3f}, paths "
          f"{sorted(paths)}; stats {gw.stats().paths}")
    if paths != {"prefill"} or miss_delta["misses"] != len(miss_users):
        raise SystemExit(f"gateway {backend} miss wave: a row was not on "
                         f"the prefill path")
    for name, n in (("hit", hit_launches), ("miss", miss_launches)):
        if min(n.values()) <= 0:
            raise SystemExit(f"gateway {backend} {name} wave: a kernel never "
                             f"launched: {n}")
        for k, v in n.items():
            launches[k] += v
    if gw.pool is not None:
        print(f"gateway pool: {gw.pool.n_slots} slots of "
              f"{gw.pool.slot_nbytes / 1e6:.3f} MB, "
              f"{gw.pool.n_slots * gw.pool.slot_nbytes / 1e9:.3f} GB on the "
              f"card; gathers {gw.pool.gathers}, scatters "
              f"{gw.pool.scatters}; cache {gw.cache.stats()}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
              f"[{gpu}]")
    return hit, miss, launches


def run_gateway_path(dev, gpu, plat, params, now, backends=GW_BACKENDS):
    """The request-level Gateway at full width, from each of ``backends``
    in turn (the host LRU and the paged state pool, interleaved): warm, a
    hit wave through inject, a miss wave through prefill. Every backend's
    responses must be bit for bit the first one's."""
    import torch
    from repro_torch.serving import Gateway, ServingConfig, ServingEngine

    cfg = plat.model_cfg
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=SERVE_BATCH, prefill_len=PANE_PREFILL,
        inject_len=PANE_INJECT, cache_capacity=PANE_CAPACITY), device=dev)
    rng = np.random.RandomState(SEED + 3)
    hit_users = fresh_users(plat.injector, now, rng, GW_USERS)
    miss_users = fresh_users(plat.injector, now, rng, GW_USERS,
                             exclude=hit_users)
    # warm-up on users outside both waves, one pane from each backend
    # (allocator, pinned host blocks), then fresh Gateways for the runs
    spare = fresh_users(plat.injector, now, rng, SERVE_BATCH,
                        exclude=np.concatenate([hit_users, miss_users]))
    for backend in sorted(set(backends)):
        gw = Gateway(eng, plat.injector,
                     gateway_config(backend, GW_CACHE_ENTRIES))
        gateway_wave(gw, spare, now, f"{backend} warm-up", gpu)
        del gw
        torch.cuda.empty_cache()

    launches = {"flash_attention": 0, "decode_attention": 0}
    runs = []
    for backend in backends:
        torch.cuda.reset_peak_memory_stats(dev)
        hit, miss, n = gateway_backend(eng, plat.injector, backend,
                                       hit_users, miss_users, now, gpu)
        for k, v in n.items():
            launches[k] += v
        runs.append((backend, hit, miss))
        torch.cuda.empty_cache()
    first, hit, miss = runs[0]
    check_gateway_slates(hit, cfg.vocab_size, "hit")
    check_gateway_slates(miss, cfg.vocab_size, "miss")
    for backend, h, m in runs[1:]:
        for a, b in zip(h + m, hit + miss):
            if not (np.array_equal(a.response.slate, b.response.slate)
                    and np.array_equal(a.response.scores,
                                       b.response.scores)):
                raise SystemExit(f"gateway {backend}: a response differs "
                                 f"from the {first} run's")
    print(f"gateway backends {list(backends)}: every response (slate and "
          f"scores, hit and miss waves) bit for bit the {first} run's")

    # bf16: the Gateway's hit slates against the engine's direct path
    differ = 0
    for lo in range(0, GW_USERS, SERVE_BATCH):
        users = hit_users[lo:lo + SERVE_BATCH]
        _, slate = serve_pane(eng, *pane_inputs(eng, plat.injector, users,
                                                now))
        got = np.stack([t.response.slate for t in hit[lo:lo + SERVE_BATCH]])
        differ += int((got != slate).any(1).sum())
    print(f"bf16 gateway hit slates vs the engine's direct prefill -> "
          f"inject -> decode_slate on the same rows: {differ} of "
          f"{GW_USERS} differ")
    del runs, hit, miss
    torch.cuda.empty_cache()
    for pool in sorted({b == "pool" for b in backends}):
        compare_gateway_fp32(dev, cfg, plat.injector, hit_users, now,
                             pool=pool)
    return launches


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
    users = fresh_users(plat.injector, now, np.random.RandomState(SEED + 7),
                        MAMBA_BATCH)
    hist, sfx = pane_inputs(eng, plat.injector, users, now)
    state = eng.prefill(*hist)
    state = eng.inject(state, *sfx, fallback_logits=state["logits"][:, -1])
    graph_vs_loop(eng, state, f"mamba2 bf16 hit pane of {MAMBA_BATCH}", gpu)
    del state
    torch.cuda.empty_cache()
    profile_pane(eng, inputs[1], gpu, label="mamba2")
    del eng, params
    torch.cuda.empty_cache()
    compare_token_paths_fp32(dev, cfg, inputs[1],
                             [(ssm_mod, "ssd_scan", ssd_plain)],
                             rows=MAMBA_FP32_ROWS, gen_device=dev,
                             strict=True)
    return launches


def run_mamba2_gateway(dev, gpu, plat, now):
    """The registered mamba2-780m at full width (bf16 weights from the
    seed) behind a Gateway that serves from the paged state pool: 256
    slots of one row's prefill state (~77 MB each), panes of MAMBA_BATCH.
    Warm 256 users, a hit wave of them (inject from the pool), a miss
    wave of 256 others that evicts under slot pressure; each timed by
    phase with its ssd_scan launches counted. The bf16 hit slates must
    equal the engine's direct prefill -> inject -> decode_slate on the
    same users and clock."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import Gateway, ServingConfig, ServingEngine

    cfg = get_config("mamba2-780m")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         torch.bfloat16, dev)
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=MAMBA_BATCH, prefill_len=PANE_PREFILL,
        inject_len=PANE_INJECT, cache_capacity=PANE_CAPACITY), device=dev)
    rng = np.random.RandomState(SEED + 4)
    hit_users = fresh_users(plat.injector, now, rng, MAMBA_GW_USERS)
    miss_users = fresh_users(plat.injector, now, rng, MAMBA_GW_USERS,
                             exclude=hit_users)
    # one direct pane of other users captures the slate graph outside the
    # timed waves
    spare = fresh_users(plat.injector, now, rng, MAMBA_BATCH,
                        exclude=np.concatenate([hit_users, miss_users]))
    serve_pane(eng, *pane_inputs(eng, plat.injector, spare, now))
    gw = Gateway(eng, plat.injector,
                 gateway_config("pool", MAMBA_POOL_SLOTS))
    kernels = ("ssd_scan",)
    panes = MAMBA_GW_USERS // MAMBA_BATCH
    launches = gateway_warm(gw, hit_users, now, "mamba2 pool", gpu, kernels)
    hit, hit_launches, _, hit_delta = gateway_wave(
        gw, hit_users, now, "mamba2 pool hit", gpu, clock=PhaseClock(),
        kernels=kernels)
    paths = {t.response.telemetry.path for t in hit}
    if hit_delta["hits"] != MAMBA_GW_USERS or paths != {"inject"}:
        raise SystemExit(f"mamba2 gateway hit wave: {hit_delta}, paths "
                         f"{sorted(paths)}")
    with slate_loop(eng):
        hit_loop, loop_launches, _, _ = gateway_wave(
            gw, hit_users, now, "mamba2 pool hit (slate loop)", gpu,
            clock=PhaseClock(), kernels=kernels)
    if any(not np.array_equal(a.response.slate, b.response.slate)
           or not np.array_equal(a.response.scores, b.response.scores)
           for a, b in zip(hit_loop, hit)):
        raise SystemExit("mamba2 gateway: the slate loop's hit wave differs "
                         "from the graph's")
    print("mamba2 gateway: the hit wave with the slate loop bit for bit the "
          "graph's")
    miss, miss_launches, _, miss_delta = gateway_wave(
        gw, miss_users, now, "mamba2 pool miss", gpu, clock=PhaseClock(),
        kernels=kernels)
    paths = {t.response.telemetry.path for t in miss}
    if miss_delta["misses"] != MAMBA_GW_USERS or paths != {"prefill"} \
            or miss_delta["evictions"] != MAMBA_GW_USERS:
        raise SystemExit(f"mamba2 gateway miss wave: {miss_delta}, paths "
                         f"{sorted(paths)}")
    want = {"warm": cfg.n_layers * panes, "hit": cfg.n_layers * panes,
            "miss": 2 * cfg.n_layers * panes}
    got = {"warm": launches["ssd_scan"], "hit": hit_launches["ssd_scan"],
           "miss": miss_launches["ssd_scan"]}
    print(f"mamba2 gateway: ssd_scan launches {got} (expected {want}: "
          f"{cfg.n_layers} a prefill, {cfg.n_layers} an inject); pool "
          f"{gw.pool.n_slots} slots of {gw.pool.slot_nbytes / 1e6:.3f} MB, "
          f"{gw.pool.n_slots * gw.pool.slot_nbytes / 1e9:.3f} GB on the "
          f"card; gathers {gw.pool.gathers}, scatters {gw.pool.scatters}; "
          f"cache {gw.cache.stats()}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB [{gpu}]")
    if got != want:
        raise SystemExit("mamba2 gateway: ssd_scan launches differ from "
                         "the expected count")
    with slate_loop(eng):
        miss_loop, miss_loop_launches, _, _ = gateway_wave(
            gw, hit_users, now, "mamba2 pool miss (slate loop)", gpu,
            clock=PhaseClock(), kernels=kernels)
    if {t.response.telemetry.path for t in miss_loop} != {"prefill"}:
        raise SystemExit("mamba2 gateway: the slate loop's miss wave left "
                         "the prefill path")
    got["loop waves"] = (loop_launches["ssd_scan"]
                         + miss_loop_launches["ssd_scan"])
    check_gateway_slates(hit, cfg.vocab_size, "mamba2 hit")
    check_gateway_slates(miss, cfg.vocab_size, "mamba2 miss")
    differ = 0
    for lo in range(0, MAMBA_GW_USERS, MAMBA_BATCH):
        users = hit_users[lo:lo + MAMBA_BATCH]
        _, slate = serve_pane(eng, *pane_inputs(eng, plat.injector, users,
                                                now))
        served = np.stack([t.response.slate
                           for t in hit[lo:lo + MAMBA_BATCH]])
        differ += int((served != slate).any(1).sum())
    print(f"bf16 mamba2 pooled gateway hit slates vs the engine's direct "
          f"prefill -> inject -> decode_slate on the same rows: {differ} of "
          f"{MAMBA_GW_USERS} differ")
    if differ:
        raise SystemExit("mamba2 gateway: a hit slate differs from the "
                         "engine's direct path")
    del gw, eng, params, hit, miss, hit_loop, miss_loop
    torch.cuda.empty_cache()
    return {"ssd_scan": sum(got.values())}


# ----------------------------------------------------------------------
# Sampled decode, the online trainer, its patches, checkpoints
# ----------------------------------------------------------------------

def run_sampled_decode(dev, gpu, plat, params, now):
    """``ServingEngine.sample`` at temperature SAMPLE_T on an itfi pane's
    first logits: with given noise it must equal ``argmax(noise + logits
    / T)``; from the card's generator, SAMPLE_DRAWS draws on one row must
    pass a chi-square test against ``softmax(logits / T)`` at p > 1e-3
    (categories expected below 5 draws pooled into one)."""
    import torch
    from scipy import stats
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = plat.model_cfg
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=SERVE_BATCH, prefill_len=PANE_PREFILL,
        inject_len=PANE_INJECT, cache_capacity=PANE_CAPACITY,
        temperature=SAMPLE_T), device=dev)
    users = fresh_users(plat.injector, now, np.random.RandomState(SEED + 8),
                        SERVE_BATCH)
    hist, sfx = pane_inputs(eng, plat.injector, users, now)
    pre = eng.prefill(*hist)
    logits = eng.inject(pre, *sfx, fallback_logits=pre["logits"][:, -1])[
        "first_logits"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.rand(logits.shape, generator=gen, device=dev)
    noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    got = eng.sample(logits, noise=noise)
    if not torch.equal(got, torch.argmax(noise + logits / SAMPLE_T,
                                         -1).to(torch.int32)):
        raise SystemExit("sample: with given noise it is not "
                         "argmax(noise + logits / T)")
    row = logits[:1].expand(SAMPLE_BATCH, -1).contiguous()
    counts = torch.zeros(cfg.vocab_padded, dtype=torch.int64, device=dev)
    for _ in range(SAMPLE_DRAWS // SAMPLE_BATCH):
        counts += torch.bincount(eng.sample(row, generator=gen).long(),
                                 minlength=cfg.vocab_padded)
    counts = counts.cpu().numpy()
    if counts[cfg.vocab_size:].any():
        raise SystemExit("sample: a draw landed in the padded vocabulary")
    probs = torch.softmax(logits[0, :cfg.vocab_size].double() / SAMPLE_T,
                          -1).cpu().numpy()
    expected = probs * SAMPLE_DRAWS
    big = expected >= 5
    obs = np.append(counts[:cfg.vocab_size][big],
                    counts[:cfg.vocab_size][~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] < 5:
        obs, exp = obs[:-1], exp[:-1]
        exp = exp * obs.sum() / exp.sum()
    chi2, p = stats.chisquare(obs, exp)
    ms = time_ms(lambda: eng.sample(logits, generator=gen))
    print(f"sampled decode at T={SAMPLE_T}: equal to argmax(noise + logits "
          f"/ T) on {SERVE_BATCH} rows for given noise; {SAMPLE_DRAWS} draws"
          f" of one row from the card's generator against softmax(logits / "
          f"T): chi-square {chi2:.1f} over {len(obs)} categories, p-value "
          f"{p:.4g} (must be > 1e-3); sample() {ms:.4f} ms a pane of "
          f"{SERVE_BATCH} x {cfg.vocab_padded} (CUDA events) [{gpu}]")
    if not p > 1e-3:
        raise SystemExit("sample: the draws do not follow softmax(logits / "
                         "T)")


def feed_log(log, rng, n, now, n_items):
    """``n`` seeded events appended to the feature plane's event log, after
    ``now``: new data for the trainer that no serving read at ``now``
    sees."""
    ts = np.sort(rng.randint(now + 1, now + 3600, n))
    log.extend(rng.randint(0, N_USERS, n), rng.randint(0, n_items, n), ts)


def patched_wave(gw, cold_params, users, now, label, gpu):
    """A wave of ``users`` on ``gw`` after a patch install, and the same
    wave on a cold pooled Gateway over an engine built from
    ``cold_params``: every response bit for bit equal."""
    import torch
    from repro_torch.serving import Gateway, ServingEngine

    hot, _, hot_s, _ = gateway_wave(gw, users, now, f"{label} hot", gpu)
    cold = Gateway(ServingEngine(gw.engine.cfg, cold_params, gw.engine.scfg,
                                 device=gw.engine.device),
                   gw.injector, gateway_config("pool", len(users)))
    want, _, cold_s, _ = gateway_wave(cold, users, now, f"{label} cold", gpu)
    version = gw.stats().model_version
    if any(t.response.telemetry.model_version != version for t in hot):
        raise SystemExit(f"{label}: a response of another model version")
    if any(not np.array_equal(a.response.slate, b.response.slate)
           or not np.array_equal(a.response.scores, b.response.scores)
           for a, b in zip(hot, want)):
        raise SystemExit(f"{label}: the hot-swapped Gateway differs from a "
                         f"cold one built from the patched weights")
    print(f"{label}: every response of {len(users)} bit for bit a cold "
          f"pooled Gateway's from the patched weights (model version "
          f"{version}; {hot_s * 1e3:.2f} ms hot, {cold_s * 1e3:.2f} ms cold "
          f"incl. the cold graph's capture)")
    del cold
    torch.cuda.empty_cache()


def train_and_patch(trainer, gw, users, now, label, gpu, steps, feed):
    """``steps`` trainer steps by hand (the first reads every event of the
    log, fresh events are fed before each later one), ``make_patch``, its bytes and back, ``install_patch`` into
    ``gw`` and the hot-vs-cold wave."""
    import torch
    from repro_torch.training import WeightPatch

    losses, step_ms = [], []
    for i in range(steps):
        if i:
            feed()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if m is None or not np.isfinite(m["loss"]):
            raise SystemExit(f"{label}: a train step ran on no batch or "
                             f"gave a non-finite loss: {m}")
        losses.append(m["loss"])
    # where a step's time goes: a fresh view of the log and its batch (host),
    # and the train step alone on that batch (the card; not applied)
    from repro_torch.training import make_train_step
    t0 = time.perf_counter()
    view = trainer.log.view()
    new_users, _, new_ts = view.events_since(view.n_events - TRAIN_BATCH)
    batch = trainer._build_batch(view, new_users, new_ts)
    host_ms = (time.perf_counter() - t0) * 1e3
    step_fn = make_train_step(trainer.model_cfg, trainer.train_cfg)
    alone = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(trainer.params, trainer._opt, batch)
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)
    patch = trainer.make_patch()
    blob = patch.to_bytes()
    back = WeightPatch.from_bytes(blob)
    if back.to_bytes() != blob:
        raise SystemExit(f"{label}: the patch does not round-trip its bytes")
    n = gw.install_patch(back)
    print(f"{label}: {steps} train steps of {TRAIN_BATCH} x {TRAIN_SEQ} on "
          f"the card, ms {[round(x, 2) for x in step_ms]} (host clock, "
          f"synchronised; the first includes reading all "
          f"{trainer.log.n_events} events), loss "
          f"{[round(x, 4) for x in losses]}; of a step, the log view and "
          f"batch {host_ms:.1f} ms (host) and the train step alone "
          f"{[round(x, 2) for x in alone]} ms (the card, synchronised); "
          f"patch v{patch.version} of "
          f"{n} leaves, {patch.n_params} params, {len(blob)} bytes; "
          f"patch_install_max_ms {gw.stats().patch_install_max_ms:.3f} "
          f"[{gpu}]")
    patched_wave(gw, trainer.params, users, now, label, gpu)


def run_online_trainer(dev, gpu, plat, params, now):
    """The online trainer on the full-width itfi-ranker over the feature
    plane's event log, its patches hot-swapped into a pooled Gateway with
    a warm slate graph, then its background worker while that Gateway
    serves, then a checkpoint of the trained weights."""
    import torch
    from repro_torch.models.common import flatten_with_keystr
    from repro_torch.serving import Gateway, Request, ServingConfig, \
        ServingEngine
    from repro_torch.training import (OnlineTrainer, OnlineTrainerConfig,
                                      load_checkpoint, save_checkpoint)

    cfg = plat.model_cfg
    n_items = cfg.vocab_size - 256
    rng = np.random.RandomState(SEED + 9)
    users = fresh_users(plat.injector, now, rng, TRAIN_USERS)
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=SERVE_BATCH, prefill_len=PANE_PREFILL,
        inject_len=PANE_INJECT, cache_capacity=PANE_CAPACITY), device=dev)
    gw = Gateway(eng, plat.injector, gateway_config("pool", TRAIN_USERS))
    gw.warm(users, now)
    gateway_wave(gw, users, now, "trainer pool warm graph", gpu)
    log = plat.injector.batch.log
    feed = functools.partial(feed_log, log, rng, 4 * TRAIN_BATCH, now,
                             n_items)
    tcfg = dict(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    t0 = time.perf_counter()
    trainer = OnlineTrainer(cfg, params, log, device=dev,
                            cfg=OnlineTrainerConfig(**tcfg))
    print(f"online trainer: {cfg.name} at full width, bf16 weights with an "
          f"f32 master on the card, made in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; AdamW "
          f"{trainer.train_cfg.adamw}")
    train_and_patch(trainer, gw, users, now, "online patch (every leaf)",
                    gpu, steps=3, feed=feed)
    delta = OnlineTrainer(cfg, trainer.params, log, device=dev,
                          base_version=gw.stats().model_version,
                          cfg=OnlineTrainerConfig(trainable=("embed",),
                                                  **tcfg))
    feed()
    train_and_patch(delta, gw, users, now, "online patch (embed delta)",
                    gpu, steps=2, feed=feed)

    # the background worker while the Gateway serves panes of new slate
    # lengths (new graph captures) and replays them
    worker = OnlineTrainer(cfg, delta.params, log, device=dev,
                           base_version=gw.stats().model_version,
                           step_hook=feed,
                           cfg=OnlineTrainerConfig(interval_s=0.0, **tcfg))
    base = worker.version
    graphs0, applied0 = len(eng.slate_graph_stats()), \
        gw.stats().patches_applied
    gw.attach_trainer(worker.start())
    tickets, t_end = [], time.perf_counter() + 120
    try:
        for k, slate_len in enumerate((7, 5, 3, 7, 5, 3)):
            tickets += gw.submit_many([
                Request(user=int(u), now=now, slate_len=slate_len)
                for u in users])
            gw.flush(now)
        while gw.stats().patches_applied == applied0 \
                and time.perf_counter() < t_end:
            time.sleep(0.05)
            gw.tick(now)
        tickets += gw.submit_many([Request(user=int(u), now=now)
                                   for u in users])
        gw.flush(now)
    finally:
        worker.stop(timeout=120)
    gw.attach_trainer(None)
    by_pane = {}
    for t in tickets:
        by_pane.setdefault(t.response.telemetry.pane_id, set()).add(
            t.response.telemetry.model_version)
    mixed = [p for p, v in by_pane.items() if len(v) != 1]
    st = gw.stats()
    print(f"online worker: {worker.steps} steps and {worker.version - base}"
          f" patches on its thread while the Gateway served {len(by_pane)} "
          f"panes; {st.patches_applied - applied0} patches installed between"
          f" panes, model version {st.model_version}; "
          f"{len(eng.slate_graph_stats()) - graphs0} slate graphs captured "
          f"while it"
          f" ran; versions seen {sorted(set().union(*by_pane.values()))}; "
          f"panes serving more than one version: {len(mixed)}; "
          f"patch_install_max_ms {st.patch_install_max_ms:.3f} [{gpu}]")
    if mixed or st.patches_applied == applied0 \
            or len(eng.slate_graph_stats()) - graphs0 != 3:
        raise SystemExit("online worker: no patch landed, a pane mixed "
                         "versions, or a slate graph was not captured")
    check_gateway_slates(tickets[-len(users):], cfg.vocab_size,
                         "online worker")

    path = os.path.join(ROOT, "build", "chip_smoke_checkpoint.msgpack")
    tree = worker.params
    t0 = time.perf_counter()
    save_checkpoint(path, tree, step=worker.steps,
                    metadata={"arch": cfg.name})
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back, step, meta = load_checkpoint(path)
    load_ms = (time.perf_counter() - t0) * 1e3
    size = os.path.getsize(path)
    os.unlink(path)
    flat = dict(flatten_with_keystr(back))
    for key, leaf in flatten_with_keystr(tree):
        got = flat[key]
        if got.dtype != leaf.dtype or not torch.equal(
                got.view(torch.int16) if got.dtype == torch.bfloat16
                else got, (leaf.view(torch.int16) if leaf.dtype ==
                           torch.bfloat16 else leaf).cpu()):
            raise SystemExit(f"checkpoint: leaf {key} does not round-trip")
    print(f"checkpoint: {len(flat)} leaves of the trained {cfg.name} "
          f"({', '.join(sorted({str(v.dtype) for v in flat.values()}))}), "
          f"{size} bytes, saved in {save_ms:.1f} ms and loaded in "
          f"{load_ms:.1f} ms with the pure-Python msgpack codec (host); "
          f"every leaf bit for bit; step {step}, metadata {meta}")
    del gw, eng
    torch.cuda.empty_cache()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ----------------------------------------------------------------------
# The paper's §IV A/B experiment
# ----------------------------------------------------------------------

class ABProbe:
    """Wraps the helpers ``core.ab.run_experiment`` calls (``train_ranker``,
    ``batches``, ``train``, ``make_platform``, ``run_arm``,
    ``simulate_day``) to time them, count kernel launches by arm, and keep
    what the later checks need: the trained params, each platform's
    arguments, the treatment arm's starting world and each day's per-user
    tallies. Every wrapper returns what the wrapped function returns."""

    def __init__(self, ab_mod):
        self.ab = ab_mod
        self.real = {n: getattr(ab_mod, n) for n in (
            "train_ranker", "batches", "train", "make_platform", "run_arm",
            "simulate_day")}
        self.arm = "bootstrap"
        self.trained = []        # (cutoff, params)
        self.trains = []         # dicts: examples, steps, ms, loss
        self.platforms = {}      # arm -> make_platform's (args, kwargs)
        self.launches = {}       # arm -> {kernel: launches}
        self.days = []           # dicts: arm, day, wall_ms, serve_ms, ...
        self.serve_ms = {}       # arm -> [ms a serve call]
        self.start_world = {}    # arm -> a copy of the world it starts from

    def patches(self):
        return [mock.patch.object(self.ab, n, getattr(self, n))
                for n in self.real]

    def train_ranker(self, events, model_cfg, ab, cutoff, **kw):
        params = self.real["train_ranker"](events, model_cfg, ab, cutoff,
                                           **kw)
        self.trained.append((cutoff, params))
        self.trains[-1]["cutoff"] = cutoff
        return params

    def batches(self, ex, *a, **kw):
        self.trains.append({"examples": len(ex["labels"])})
        return self.real["batches"](ex, *a, **kw)

    def train(self, *a, **kw):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.real["train"](*a, **kw)
        torch.cuda.synchronize()
        hist = out["history"]
        self.trains[-1].update(ms=(time.perf_counter() - t0) * 1e3,
                               steps=len(hist), loss=hist[-1]["loss"])
        return out

    def make_platform(self, *a, **kw):
        plat = self.real["make_platform"](*a, **kw)
        plat.make_args = (a, kw)
        serve = plat.serve

        def timed_serve(users, tss):
            t0 = time.perf_counter()
            out = serve(users, tss)          # a host array: synchronised
            self.serve_ms.setdefault(self.arm, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        plat.serve = timed_serve
        return plat

    def run_arm(self, name, ab, platform, world, day_range, **kw):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.history_merge.ops import history_merge
        self.arm = name
        self.platforms[name] = platform.make_args
        self.start_world[name] = copy.deepcopy(world)
        before = (flash_attention.launches, history_merge.launches)
        out = self.real["run_arm"](name, ab, platform, world, day_range,
                                   **kw)
        self.launches[name] = {
            "flash_attention": flash_attention.launches - before[0],
            "history_merge": history_merge.launches - before[1]}
        return out

    def simulate_day(self, world, day, serve_fn, observe_fn, **kw):
        n_serve = len(self.serve_ms.get(self.arm, []))
        t0 = time.perf_counter()
        events, m = self.real["simulate_day"](world, day, serve_fn,
                                              observe_fn, **kw)
        wall = (time.perf_counter() - t0) * 1e3
        serve = sum(self.serve_ms.get(self.arm, [])[n_serve:])
        self.days.append(dict(
            arm=self.arm, day=day, wall_ms=wall, serve_ms=serve,
            events=len(events), user_impressions=m["user_impressions"].copy(),
            user_watches=m["user_watches"].copy()))
        return events, m


def ab_serve_record(plat, users, now, plain):
    """One ``plat.serve`` call, with the kernels or (``plain``) with their
    plain versions; returns the serve core's tokens, slate and candidates
    and the ranker's last-position logits on those tokens."""
    import torch
    from repro_torch.core import injection as injection_mod
    from repro_torch.core import pipeline as pipeline_mod
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.history_merge.ref import history_merge_ref
    from repro_torch.models import attention as attention_mod

    seen = []
    real = pipeline_mod._serve_core

    def spy(ranker, tokens, valid, pop_prior, **kw):
        slate, cand = real(ranker, tokens, valid, pop_prior, **kw)
        last = ranker(tokens.long(), valid=valid > 0, last_only=True)[:, -1]
        seen.append((tokens.clone(), slate, cand, last))
        return slate, cand
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(pipeline_mod, "_serve_core",
                                              spy))
        if plain:
            stack.enter_context(mock.patch.object(
                attention_mod, "flash_attention", attention_ref))
            stack.enter_context(mock.patch.object(
                injection_mod, "history_merge", history_merge_ref))
        plat.serve(users, np.full(len(users), now))
    torch.cuda.synchronize()
    return seen[0]


def compare_ab_modes_fp32(dev, probe, ab, cfg, now):
    """One serve call of AB_FP32_USERS users at ``now`` in each serving
    mode of the experiment, with the trained gen-2 params upcast to fp32:
    the kernel path against the plain path on the same card. Tokens and
    candidates must be equal, last-position logits within E2E_TOL, and a
    slate may differ only on a row whose top slate_size + 1 candidate
    scores tie within E2E_TOL; such rows are counted."""
    import torch
    from repro_torch.models.common import tree_map

    m2 = {cut: tree_map(lambda t: t.float(), p)
          for cut, p in probe.trained[1:]}
    users = np.arange(AB_FP32_USERS)
    world = probe.start_world["control"]
    history = probe.platforms["control"][0][4]
    modes = {"inject": (m2["midnight"], dict(policy="inject")),
             "batch": (m2["midnight"], dict(policy="batch")),
             "consistent": (m2["fresh"], dict(policy="inject",
                                              mode="consistent")),
             "staleness=3600": (m2["midnight"], dict(policy="batch",
                                                     staleness=3600))}
    for mode, (params, kw) in modes.items():
        plat = probe.real["make_platform"](ab, cfg, params, world, history,
                                           device=dev, **kw)
        k_tok, k_slate, k_cand, k_last = ab_serve_record(plat, users, now,
                                                         False)
        p_tok, p_slate, p_cand, p_last = ab_serve_record(plat, users, now,
                                                         True)
        if not (torch.equal(k_tok, p_tok) and torch.equal(k_cand, p_cand)):
            raise SystemExit(f"A/B fp32 {mode}: kernel and plain paths "
                             f"disagree on tokens or candidates")
        if not torch.isfinite(k_last[:, :cfg.vocab_size]).all():
            raise SystemExit(f"A/B fp32 {mode}: non-finite logits")
        err = float((k_last - p_last).abs().max())
        torch.testing.assert_close(k_last, p_last, atol=E2E_TOL,
                                   rtol=E2E_TOL)
        gap = top_score_gap(p_last, p_cand, plat.pcfg.slate_size)
        tie = gap <= E2E_TOL
        differ = (k_slate != p_slate).any(1)
        n = len(users)
        print(f"A/B fp32 {mode}, {n} users at the first A/B day's clock: "
              f"tokens and candidates equal, last-position logits max abs "
              f"err {err:.3g} (tolerance {E2E_TOL}), {int(differ[:n].sum())} "
              f"slates differ, {int(tie[:n].sum())} rows tie within "
              f"{E2E_TOL}; top-score gaps of the differing rows: "
              f"{[f'{x:.3g}' for x in gap[:n][differ[:n]].tolist()]}")
        if (differ & ~tie)[:n].any():
            raise SystemExit(f"A/B fp32 {mode}: a slate differs on a row "
                             f"whose top scores do not tie within "
                             f"{E2E_TOL}")
        del plat
    torch.cuda.empty_cache()


def run_ab_experiment(dev, gpu, report):
    """Phase 17: ``run_experiment`` on the full-width ``itfi-ranker``,
    its checks, a determinism rerun of the treatment's first A/B day, the
    kernel path against the plain path at fp32 in every serving mode, and
    both kernels timed at the experiment's own inputs. Returns the
    kernels' launches in the run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import ab as ab_mod
    from repro_torch.core import injection as injection_mod
    from repro_torch.data.synthetic import WorldConfig
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.history_merge.ops import history_merge
    from repro_torch.kernels.history_merge.ref import history_merge_ref
    from repro_torch.models import attention as attention_mod

    t_phase = time.perf_counter()
    cfg = get_config("itfi-ranker")
    ab = ab_mod.ABConfig(world=WorldConfig(
        n_users=AB_USERS, n_items=cfg.vocab_size - 256, sessions_per_day=2.0,
        seed=SEED), latency_arms=(3600,), seed=SEED)
    probe = ABProbe(ab_mod)
    rec_fa, fa_calls = record_calls(attention_mod, "flash_attention")
    rec_hm, hm_calls = record_calls(injection_mod, "history_merge")
    log_lines = []
    with contextlib.ExitStack() as stack:
        for p in probe.patches() + [rec_fa, rec_hm]:
            stack.enter_context(p)
        history_merge.launches = flash_attention.launches = 0
        t0 = time.perf_counter()
        rep = ab_mod.run_experiment(ab, model_cfg=cfg, log=log_lines.append,
                                    device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {"history_merge": history_merge.launches,
                    "flash_attention": flash_attention.launches}
    print(f"A/B experiment ({cfg.name}, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim_}, vocab "
          f"{cfg.vocab_size}; {AB_USERS} users, {ab.world.n_items} items, "
          f"days {ab.bootstrap_days}+{ab.gen1_days}+{ab.ab_days}, "
          f"feature_len {ab.feature_len}, rt_buffer_len "
          f"{ab.rt_buffer_len}): run_experiment {run_s:.1f} s (host "
          f"clock); launches {launches}")
    for line in log_lines:
        if not line.startswith("step "):
            print(f"  {line}")

    # ---- the report and the JAX integration test's checks -------------
    arms = rep["arms"]
    for name, a in arms.items():
        print(f"A/B arm {name}: ctr {a['ctr']:.5f}, impressions "
              f"{a['impressions']}, watches {a['watches']}")
    for name, t in rep["tests"].items():
        print(f"A/B test {name}: lift {t['lift']:+.5f}, 95% CI "
              f"[{t['ci_lo']:+.5f}, {t['ci_hi']:+.5f}], p_t {t['p_t']:.4g}, "
              f"pooled z {t['z_pooled']:+.3f} (p {t['p_pooled']:.4g}), "
              f"{t['n_users']} paired users, significant {t['significant']}")
    want_arms = {"control", "treatment", "consistent", "stale_3600s"}
    if set(arms) != want_arms:
        raise SystemExit(f"A/B arms {sorted(arms)}")
    if len({a["impressions"] for a in arms.values()}) != 1:
        raise SystemExit("A/B arms faced different impressions")
    ui = [r.user_impressions for r in rep["results"].values()]
    if any(not np.array_equal(x, ui[0]) for x in ui[1:]):
        raise SystemExit("A/B arms faced different per-user impressions")
    if not all(0.0 < a["ctr"] < 0.9 for a in arms.values()):
        raise SystemExit("an A/B arm's CTR is outside (0, 0.9)")
    if not all(t["ci_lo"] <= t["lift"] <= t["ci_hi"]
               for t in rep["tests"].values()):
        raise SystemExit("an A/B lift lies outside its bootstrap CI")
    print("A/B checks: every arm faced identical impressions, user by user; "
          "every CTR in (0, 0.9); every lift inside its CI")

    # ---- kernel launches by arm -----------------------------------------
    print(f"A/B launches by arm: {probe.launches}")
    for name, n in probe.launches.items():
        if n["flash_attention"] <= 0:
            raise SystemExit(f"A/B {name}: flash_attention never launched")
        if (n["history_merge"] > 0) != (name == "treatment"):
            raise SystemExit(f"A/B {name}: history_merge launched "
                             f"{n['history_merge']} times")
    if set(probe.launches) != {"gen1"} | want_arms:
        raise SystemExit(f"A/B runs {sorted(probe.launches)}")

    # ---- times --------------------------------------------------------
    for t in probe.trains:
        print(f"time train_ranker {t['cutoff']}: {t['examples']} examples, "
              f"{t['steps']} steps, {t['ms'] / t['steps']:.2f} ms a step "
              f"(host clock around the train loop, synchronised), final "
              f"loss {t['loss']:.4f} [{gpu}]")
    by_arm = {}
    for d in probe.days:
        by_arm.setdefault(d["arm"], []).append(d)
    for name, days in by_arm.items():
        host = ", ".join(f"{d['wall_ms'] - d['serve_ms']:.0f}" for d in days)
        wall = ", ".join(f"{d['wall_ms']:.0f}" for d in days)
        print(f"time simulate_day {name}: host ms a day (without its serve "
              f"calls) {host}; wall ms a day {wall}")
    for name, ms in probe.serve_ms.items():
        if name == "bootstrap":
            continue
        print(f"time A/B serve {name}: {np.mean(ms):.2f} ms a call (median "
              f"{np.median(ms):.2f}, {len(ms)} calls of up to 256 users; "
              f"host clock, ends in the slate's copy to the host) [{gpu}]")

    # ---- determinism: the treatment's first A/B day again -------------
    start = ab.bootstrap_days + ab.gen1_days
    first = next(d for d in probe.days
                 if d["arm"] == "treatment" and d["day"] == start)
    a, kw = probe.platforms["treatment"]
    plat = probe.real["make_platform"](*a, **kw)
    again = probe.real["run_arm"]("treatment", ab, plat,
                                  copy.deepcopy(probe.start_world["treatment"]),
                                  range(start, start + 1), log=None)
    res = rep["results"]["treatment"]
    if again.day_metrics[0] != res.day_metrics[0] \
            or not np.array_equal(again.user_impressions,
                                  first["user_impressions"]) \
            or not np.array_equal(again.user_watches, first["user_watches"]):
        raise SystemExit("A/B treatment's first day differs on a rerun from "
                         "the same world and params")
    print(f"A/B determinism: the treatment's day {start} rerun from the same "
          f"world snapshot and trained params: day metrics and per-user "
          f"tallies bit for bit the first run's ({again.day_metrics[0]})")
    del plat

    # ---- kernel path against plain path at fp32, every mode ----------
    compare_ab_modes_fp32(dev, probe, ab, cfg, start * DAY + 12 * 3600)

    # ---- the kernels at the experiment's own inputs -------------------
    time_flash_at("ab", *fa_calls[0], "A/B ranker's own inputs (S=48)",
                  report, gpu)
    (hm_args, hm_kw), = hm_calls
    got = history_merge(*hm_args, **hm_kw)
    want = history_merge_ref(*hm_args, **hm_kw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("history_merge differs from its plain version at "
                         "the A/B treatment's inputs")
    print("history_merge at the A/B treatment's inputs: bit-equal to the "
          "plain version")
    report["history_merge"].update(
        {f"ab_{k}": v for k, v in time_merge(
            hm_args, hm_kw["out_len"], "the A/B treatment's inputs",
            gpu).items()})
    del fa_calls, hm_calls, probe, rep
    torch.cuda.empty_cache()
    print(f"time A/B phase: {time.perf_counter() - t_phase:.1f} s (host "
          f"clock) [{gpu}]")
    return launches

# ----------------------------------------------------------------------
# The scenario harness through the Gateway
# ----------------------------------------------------------------------

def scenario_record():
    """The JAX package's scenario record, by (name, arch)."""
    with open(os.path.join(ROOT, "BENCH_scenarios.json")) as f:
        return {(r["name"], r["arch"]): r for r in json.load(f)["results"]}


def record_mismatches(result, want):
    """{field: (got, recorded)} over the sim-time metrics and gateway
    counters that the record holds and the reference still gives
    (``RECORD_*``), for a ``ScenarioResult.as_dict()``-shaped ``result``
    and the record's entry ``want``. The record predates the "decay"
    path: a path it lacks must be 0."""
    bad = {}

    def cmp(name, got, rec):
        if name.endswith(".paths"):
            got = {k: v for k, v in got.items() if k in rec or v}
        if got != rec:
            bad[name] = (got, rec)

    for k in RECORD_METRICS:
        cmp(f"metrics.{k}", result["metrics"][k], want["metrics"][k])
    got, rec = result["gateway_stats"], want["gateway_stats"]
    for k in RECORD_COUNTERS:
        cmp(f"gateway_stats.{k}", got[k], rec[k])
    for k in RECORD_ROLLOVER:
        cmp(f"gateway_stats.rollover.{k}", got["rollover"][k],
            rec["rollover"][k])
    return bad


def timed_replay(replay, gw, trace, spec, runs):
    """``replay`` (``loadgen.replay``) from a device synchronise to a device
    synchronise, with the scenario kernels' counters set to 0 just before
    it and read just after; appends {"s", "launches", "tickets"} to
    ``runs`` and returns the tickets."""
    import torch
    ops = kernel_ops(SCENARIO_KERNELS)
    torch.cuda.synchronize()
    for op in ops.values():
        op.launches = 0
    t0 = time.perf_counter()
    tickets = replay(gw, trace, spec)
    torch.cuda.synchronize()
    runs.append({"s": time.perf_counter() - t0, "tickets": tickets,
                 "launches": {n: op.launches for n, op in ops.items()}})
    return tickets


def report_replay(label, result, run, gpu, record, wall_gates="assert"):
    """Print one scenario x arch replay and hold it against the record:
    the trace fingerprint and ``record_mismatches``; the SLO gates must
    all pass (``wall_gates="assert"``) or all but the wall-clock ones,
    which are printed with budget and actual ("print")."""
    name, arch = result["name"], result["arch"]
    m, st = result["metrics"], result["gateway_stats"]
    want = record[(name, arch)]
    wall = ", ".join(f"{g} {'-' if v is None else f'{v:.2f}'}"
                     for g, v in m["wall_ms_p99"].items())
    print(f"scenario {label}: {m['requests']} requests ({m['served']} "
          f"served, {m['shed']} shed, hit rate {m['hit_rate']:.4f}) in "
          f"{st['panes']} panes, replay {run['s']:.3f} s, "
          f"{m['requests'] / run['s']:.1f} requests/s (host clock, ending "
          f"in a device synchronise); wall_ms_p99 {wall}; launches "
          f"{run['launches']}; trace {result['trace_fingerprint']}, slates "
          f"{result['slate_fingerprint']} [{gpu}]")
    print(f"  against the record: trace {want['trace_fingerprint']}; "
          f"rollover invalidated {st['rollover']['invalidated']} (record "
          f"{want['gateway_stats']['rollover']['invalidated']}, retained "
          f"{st['rollover']['retained']}), cache {st['cache']} (record "
          f"{want['gateway_stats']['cache']})")
    if result["trace_fingerprint"] != want["trace_fingerprint"]:
        raise SystemExit(f"scenario {label}: trace fingerprint "
                         f"{result['trace_fingerprint']} != the record's")
    bad = record_mismatches(result, want)
    if bad:
        raise SystemExit(f"scenario {label}: differs from the record: {bad}")
    for g in result["gates"]:
        wall_gate = g["gate"].startswith(("wall_ms_p99", "boundary_slice"))
        if wall_gate and wall_gates == "print":
            print(f"  wall gate {g['gate']}: budget {g['budget']}, actual "
                  f"{g['actual']}, {'met' if g['pass'] else 'MISSED'} "
                  f"[{gpu}]")
        elif not g["pass"]:
            raise SystemExit(f"scenario {label}: SLO gate failed: {g}")
    print(f"  {label}: fingerprint and counters equal the record; "
          f"{'every gate passed' if wall_gates == 'assert' else 'every sim-time gate passed'}")


def scenario_result(loadgen, spec, gw, trace, tickets):
    """``run_scenario``'s ``ScenarioResult`` of one replay, as a dict."""
    st = gw.stats()
    metrics = loadgen.collect_metrics(tickets, st)
    passed, gates = loadgen.evaluate_slo(spec.slo, metrics)
    return loadgen.ScenarioResult(
        name=spec.name, arch=spec.archs[0] if spec.archs else None,
        trace_fingerprint=trace.fingerprint,
        slate_fingerprint=loadgen.slate_fingerprint(tickets),
        metrics=metrics, gates=gates, slo_pass=passed,
        gateway_stats=st.as_dict()).as_dict()


def replay_with_engine(loadgen, spec, eng, runs, plain=()):
    """``_compile_warmup``, ``build_gateway(spec, engine=eng)``, warm the
    seen users and a timed replay; with ``plain`` (patches) all of it
    runs the plain versions and the eager slate loop. Returns (gateway,
    trace, tickets)."""
    trace = loadgen.make_trace(spec)
    with contextlib.ExitStack() as stack:
        for module, name, fn in plain:
            stack.enter_context(mock.patch.object(module, name, fn))
        stack.enter_context(slate_loop(eng, bool(plain)))
        loadgen._compile_warmup(spec, None, engine=eng)
        gw = loadgen.build_gateway(spec, engine=eng)
        gw.warm(np.arange(spec.seen_users or spec.n_users), spec.start)
        tickets = timed_replay(loadgen.replay, gw, trace, spec, runs)
    return gw, trace, tickets


def compare_scenario_paths(dev, loadgen, eng, gpu):
    """(b): churn_heavy at smoke size, fp32, kernel path, plain path,
    kernel path: slates equal but on rows whose plain top first-logit
    scores tie within 1e-4 (counted), scores within 1e-4, and the second
    kernel replay bit for bit the first."""
    import torch
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import attention as attention_mod

    spec = loadgen.get_scenario("churn_heavy", smoke=True)
    plain = ((attention_mod, "flash_attention", attention_ref),
             (attention_mod, "decode_attention", decode_attention_ref))
    runs = []
    gw, _, k1 = replay_with_engine(loadgen, spec, eng, runs)
    p = replay_with_engine(loadgen, spec, eng, runs, plain)[2]
    k2 = replay_with_engine(loadgen, spec, eng, runs)[2]
    if runs[0]["launches"]["decode_attention"] <= 0 or \
            runs[0]["launches"]["flash_attention"] <= 0 or \
            any(runs[1]["launches"].values()):
        raise SystemExit(f"churn_heavy kernel vs plain: launches "
                         f"{[r['launches'] for r in runs]}")
    if [t.response.shed for t in k1] != [t.response.shed for t in p]:
        raise SystemExit("churn_heavy: shed markers differ, kernel vs plain")
    served = [(a.response, b.response) for a, b in zip(k1, p)
              if not a.response.shed]
    ks = torch.from_numpy(np.stack([a.scores for a, _ in served]))
    ps = torch.from_numpy(np.stack([b.scores for _, b in served]))
    err = float((ks - ps).abs().max())
    torch.testing.assert_close(ks, ps, atol=E2E_TOL, rtol=E2E_TOL)
    flipped = np.flatnonzero([not np.array_equal(a.slate, b.slate)
                              for a, b in served])
    top = ps[flipped].sort(1, descending=True).values[
        :, :gw.cfg.slate_len + 1]
    gaps = (top[:, :-1] - top[:, 1:]).min(1).values.tolist() \
        if len(flipped) else []
    fp1, fp2 = (loadgen.slate_fingerprint(k1),
                loadgen.slate_fingerprint(k2))
    print(f"scenario churn_heavy (smoke) fp32, kernel path vs plain path: "
          f"{len(served)} served responses, scores max abs err {err:.3g} "
          f"(tolerance {E2E_TOL}), {len(flipped)} slates differ, smallest "
          f"top-score gap of each: {[f'{g:.3g}' for g in gaps]}; kernel "
          f"replays {fp1}, {fp2}; launches "
          f"{[r['launches'] for r in runs]}; replay s "
          f"{[round(r['s'], 3) for r in runs]} [{gpu}]")
    if any(g > E2E_TOL for g in gaps):
        raise SystemExit("churn_heavy: a slate differs on a row whose top "
                         "scores are separated by more than the tolerance")
    if fp1 != fp2:
        raise SystemExit("churn_heavy: the second kernel replay differs")


def full_width_engine(dev, arch, spec):
    """A registered arch at full width, bf16 weights from the seed drawn
    on the card, behind the scenario's ServingConfig."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         torch.bfloat16, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=spec.max_batch, prefill_len=spec.prefill_len,
        inject_len=spec.inject_len,
        cache_capacity=spec.prefill_len + spec.inject_len + 64), device=dev)
    del params
    torch.cuda.empty_cache()
    print(f"scenario engine {arch}: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params "
          f"({cfg.active_param_count() / 1e9:.3f} B active a token) in "
          f"bf16 from seed {SEED}; panes of {spec.max_batch}, prefill "
          f"{spec.prefill_len}, inject {spec.inject_len}")
    return eng


def run_scenarios(dev, gpu):
    """Phase 18: the named traffic scenarios through the port's Gateway,
    (a) at the harness's own fp32 engines against the JAX package's
    record with every gate asserted, (b) kernel path against plain path
    on churn_heavy, (c) at full width with bf16 weights. The harness's
    wall-clock budgets were calibrated on the tiny models on a CPU host
    (``serving/loadgen.py``'s ``_WALL_BUDGETS``), so at full width they
    are printed, not asserted. Returns the kernels' launches in the
    replays of (a) and (c)."""
    import gc

    import torch
    from repro_torch.serving import loadgen

    t_phase = time.perf_counter()
    record = scenario_record()
    launches = dict.fromkeys(SCENARIO_KERNELS, 0)

    def add(runs):
        for run in runs:
            for n, k in run["launches"].items():
                launches[n] += k

    # ---- (a) the harness's own engines, fp32 --------------------------
    for name in loadgen.SCENARIO_NAMES:
        spec = loadgen.get_scenario(name)
        runs = []
        real = loadgen.replay
        t0 = time.perf_counter()
        with mock.patch.object(loadgen, "replay", lambda gw, tr, sp:
                               timed_replay(real, gw, tr, sp, runs)):
            results = loadgen.run_scenario(spec, device=dev)
        wall_s = time.perf_counter() - t0
        print(f"scenario {name} (harness engines, fp32): run_scenario "
              f"{wall_s:.2f} s in all (warm-up, warm and replay) [{gpu}]")
        for res, run in zip(results, runs):
            report_replay(f"{name} [{res.arch or 'harness ranker'}, fp32]",
                          res.as_dict(), run, gpu, record)
        add(runs)

    # ---- (b) kernel path against plain path ---------------------------
    spec = loadgen.get_scenario("churn_heavy", smoke=True)
    compare_scenario_paths(dev, loadgen, loadgen._engine_for(spec, None, dev),
                           gpu)
    loadgen._ENGINE_CACHE.clear()

    # ---- (c) full width, bf16 -----------------------------------------
    wide = [(SCENARIO_WIDE, n) for n in loadgen.SCENARIO_NAMES
            if not loadgen.get_scenario(n).archs]
    wide += [(a, "mixed_fleet")
             for a in loadgen.get_scenario("mixed_fleet").archs]
    eng, eng_arch = None, None
    for arch, name in wide:
        spec = loadgen.get_scenario(name)
        if eng_arch != arch:
            eng = None
            gc.collect()
            torch.cuda.empty_cache()
            eng, eng_arch = full_width_engine(dev, arch, spec), arch
        if spec.archs:
            spec = dataclasses.replace(spec, archs=(arch,))
        runs = []
        t0 = time.perf_counter()
        gw, trace, tickets = replay_with_engine(loadgen, spec, eng, runs)
        wall_s = time.perf_counter() - t0
        res = scenario_result(loadgen, spec, gw, trace, tickets)
        print(f"scenario {name} on {arch} (full width, bf16): "
              f"{wall_s:.2f} s in all (warm-up, warm and replay) [{gpu}]")
        if arch == "mamba2-780m":
            c = gw.cache.stats()
            print(f"  mamba2 host LRU: {c['entries']} entries, "
                  f"{c['bytes_per_shard'] / 1e9:.2f} GB of host memory "
                  f"({c['bytes_per_shard'] / max(c['entries'], 1) / 1e6:.1f}"
                  f" MB an entry)")
        report_replay(f"{name} [{arch}, bf16]", res, runs[0], gpu, record,
                      wall_gates="print")
        add(runs)
        if name == "churn_heavy":
            again = []
            _, _, tickets2 = replay_with_engine(loadgen, spec, eng, again)
            fp2 = loadgen.slate_fingerprint(tickets2)
            print(f"  churn_heavy [{arch}, bf16] again: slates {fp2} "
                  f"(first {res['slate_fingerprint']}), replay "
                  f"{again[0]['s']:.3f} s, launches {again[0]['launches']}")
            if fp2 != res["slate_fingerprint"]:
                raise SystemExit("churn_heavy at full width: the second "
                                 "replay differs from the first")
            add(again)
        del gw, tickets
    eng = None
    gc.collect()
    torch.cuda.empty_cache()
    print(f"time scenario phase: {time.perf_counter() - t_phase:.1f} s "
          f"(host clock); launches {launches} [{gpu}]")
    return launches


# ----------------------------------------------------------------------
# Phase 19: the frontend archs at full width through the step layer
# ----------------------------------------------------------------------

def phase_memory(label, dev):
    """Prints the peak device memory since the last reset, then resets."""
    import torch
    torch.cuda.synchronize()
    print(f"  memory after {label}: peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB held now")
    torch.cuda.reset_peak_memory_stats(dev)


def counted(fn, *args, **kwargs):
    """``fn(*args)`` from a device synchronise to a device synchronise,
    with the attention kernels' counters set to 0 just before it and read
    just after: (result, launches, seconds)."""
    import torch
    ops = kernel_ops(FRONTEND_KERNELS)
    torch.cuda.synchronize()
    for op in ops.values():
        op.launches = 0
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, {n: op.launches for n, op in ops.items()}, \
        time.perf_counter() - t0


def profile_call(fn, label, gpu, top=5):
    """``fn()`` once under the profiler: its device-busy ms (the summed
    kernel durations) against its host ms, and the kernels that take the
    most device time. Returns ``fn()``'s result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    per = sorted(((e.key, _device_us(e) / 1e3) for e in prof.key_averages()
                  if _device_us(e) > 0), key=lambda kv: -kv[1])
    busy = sum(v for _, v in per)
    print(f"profile {label}: device busy {busy:.1f} ms of {host_ms:.1f} ms "
          f"(host clock, under the profiler; idle share "
          f"{1 - busy / host_ms:.3f}); by kernel: " + ", ".join(
              f"{k[:48]} {v:.1f} ms" for k, v in per[:top]) + f" [{gpu}]")
    return out


def add_launches(total, launches):
    for n, k in launches.items():
        total[n] = total.get(n, 0) + k


def check_like(real, meta, label):
    """``real``'s leaves have the shapes and dtypes of the step layer's
    example args ``meta`` (made on the meta device)."""
    from repro_torch.models.common import flatten_with_keystr
    got = [(p, tuple(t.shape), t.dtype) for p, t in flatten_with_keystr(real)]
    want = [(p, tuple(t.shape), t.dtype) for p, t in flatten_with_keystr(meta)]
    if got != want:
        raise SystemExit(f"{label}: the inputs differ from the step layer's "
                         f"example args: {got[:3]} against {want[:3]}")


def flash_sdpa(args, window):
    """One PyTorch call computing flash_attention's function on ``args``:
    SDPA with ``is_causal`` where the mask is plain causal (every key valid,
    query and key positions the same run of consecutive integers, no window
    that cuts), else with the mask as a bias."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask
    q, k, v, qpos, kpos, kvalid = args
    sk = k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gqa = {"enable_gqa": True} if q.shape[2] != k.shape[2] else {}
    causal = bool(kvalid.all()) and torch.equal(qpos, kpos) \
        and (window == 0 or window >= sk) \
        and bool((qpos[:, 1:] - qpos[:, :-1] == 1).all())
    if causal:
        return (lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)), \
            "is_causal"
    bias = torch.where(attention_mask(qpos, kpos, kvalid, window), 0.0,
                       NEG_INF).to(q.dtype)[:, None]
    return (lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias, **gqa)), \
        "bias"


def scaled_errors(got, want):
    """(max |got - want| / max |want|, ||got - want|| / ||want||)."""
    d, w = got.float() - want.float(), want.float()
    return float(d.abs().max() / w.abs().max()), float(d.norm() / w.norm())


def within_scaled(got, want) -> bool:
    rel_max, rel_rms = scaled_errors(got, want)
    return rel_max <= FRONTEND_REL_MAX_TOL and rel_rms <= FRONTEND_REL_RMS_TOL


def assert_scaled(got, want, kind, label):
    """The kernel's ``got`` against the plain ``want``: TOL's absolute and
    relative limit and the scaled ones; returns the scaled errors."""
    import torch
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[kind],
                               rtol=TOL[kind])
    if not within_scaled(got, want):
        rel_max, rel_rms = scaled_errors(got, want)
        raise SystemExit(
            f"{label}: max err {rel_max:.3g} of max |plain| (limit "
            f"{FRONTEND_REL_MAX_TOL}), relative RMS err {rel_rms:.3g} "
            f"(limit {FRONTEND_REL_RMS_TOL})")
    return scaled_errors(got, want)


def planted_controls(want, half, kind, label):
    """The check must fail a zero output and ``half``, the plain version
    with every other live key dropped; returns their readings, with
    whether TOL's absolute limit alone would have passed each."""
    import torch
    readings = []
    for name, bad in (("zeros", torch.zeros_like(want)),
                      ("half the keys", half)):
        if within_scaled(bad, want):
            raise SystemExit(f"{label}: the check passes a planted wrong "
                             f"output ({name})")
        rel_max, rel_rms = scaled_errors(bad, want)
        old = torch.allclose(bad.float(), want.float(), atol=TOL[kind],
                             rtol=TOL[kind])
        readings.append(f"{name} {rel_max:.3g}/{rel_rms:.3g} (TOL alone "
                        f"{'passes' if old else 'fails'} it)")
    return "planted controls failed, scaled max/RMS err: " + ", ".join(
        readings)


def check_flash_rows(prefix, args, window, label, report, gpu, iters=3):
    """flash_attention at one of phase 19's recorded layer-0 calls: the
    kernel's output against attention_ref over every query row, in chunks
    of FRONTEND_ROW_CHUNK rows (each chunk is the reference's own rows: a
    query row's output depends on its row alone) held to ``assert_scaled``,
    with the chunks' device time summed as the plain version's time, and
    the planted controls on the last chunk; then the kernel's and SDPA's
    device times from a profiler trace and the bound of these inputs."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v, qpos, kpos, kvalid = args
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    kind = str(q.dtype).split(".")[1]
    got = flash_attention(*args, window=window)
    if not torch.isfinite(got).all():
        raise SystemExit(f"flash_attention at the {label}: non-finite output")
    err, rel_max, rel_rms, plain_ms = 0.0, 0.0, 0.0, 0.0
    for i in range(0, sq, FRONTEND_ROW_CHUNK):
        rows = slice(i, i + FRONTEND_ROW_CHUNK)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = attention_ref(q[:, rows], k, v, qpos[:, rows], kpos, kvalid,
                             window=window)
        end.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
        err = max(err, float((got[:, rows].float() - want.float()).abs().max()))
        rm, rr = assert_scaled(got[:, rows], want, kind,
                               f"flash_attention at the {label}, query rows "
                               f"{i}..{i + FRONTEND_ROW_CHUNK}")
        rel_max, rel_rms = max(rel_max, rm), max(rel_rms, rr)
        if i + FRONTEND_ROW_CHUNK >= sq:
            every_other = (torch.arange(sk, device=kvalid.device) % 2 == 0)
            half = attention_ref(q[:, rows], k, v, qpos[:, rows], kpos,
                                 kvalid & every_other, window=window)
            controls = planted_controls(want, half, kind,
                                        f"flash_attention at the {label}")
            del half
        del want
    del got
    ms, _ = device_ms(lambda: flash_attention(*args, window=window), iters, 1)
    sdpa, how = flash_sdpa(args, window)
    library_ms, lib_kernels = device_ms(sdpa, iters, 1)
    n_bytes, n_ops, live = attention_work(args, window)
    bound_ms, bound_by = bound(n_bytes, n_ops, kind)
    print(f"flash_attention {kind} at the {label} (B={b}, Sq={sq}, Sk={sk}, "
          f"{nq}/{nkv} heads of {hd}, window {window}): max abs err {err:.3g} "
          f"vs the plain version over all {sq} query rows (tolerance "
          f"{TOL[kind]}), worst chunk's scaled max err {rel_max:.3g} (limit "
          f"{FRONTEND_REL_MAX_TOL}) and relative RMS err {rel_rms:.3g} "
          f"(limit {FRONTEND_REL_RMS_TOL}); last chunk's {controls}; kernel "
          f"{ms:.3f} ms on the device, plain "
          f"{plain_ms:.3f} ms (in chunks of {FRONTEND_ROW_CHUNK} query rows, "
          f"CUDA events), sdpa ({how}) {library_ms:.3f} ms "
          f"({', '.join(x[:40] for x in lib_kernels)}), kernel/sdpa "
          f"{ms / library_ms:.2f}, bound {bound_ms:.3f} ms ({bound_by}; "
          f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e12:.3f} TFLOP), kernel/bound "
          f"{ms / bound_ms:.2f}; {b * nkv} CTAs on "
          f"{torch.cuda.get_device_properties(q.device).multi_processor_count}"
          f" SMs [{gpu}]")
    report["flash_attention"].update({
        f"{prefix}_{key}": val for key, val in dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
            rel_max_err=rel_max, rel_rms_err=rel_rms).items()})


def check_decode_at(prefix, args, label, report, gpu):
    """decode_attention at one of phase 19's recorded layer-0 calls: the
    kernel against decode_attention_ref, held to ``assert_scaled``, with
    the planted controls; then the kernel's, the plain version's and
    SDPA's times and the bound (the live slots' K/V once, q and o once).
    The three times are all by CUDA events over back-to-back calls: at
    Sq = 1 the profiler's trace of SDPA has summed to less than the bytes'
    bound (cuDNN's device time is not wholly in it), so it is printed
    beside the kernel's trace time and not used."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, ring_live)
    q, k, v, pos, stored = args
    b, w, nkv, hd = k.shape
    nq = q.shape[2]
    kind = str(q.dtype).split(".")[1]
    got = decode_attention(*args)
    want = decode_attention_ref(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise SystemExit(f"decode_attention at the {label}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    rel_max, rel_rms = assert_scaled(got, want, kind,
                                     f"decode_attention at the {label}")
    every_other = torch.arange(w, device=stored.device) % 2 == 0
    controls = planted_controls(
        want, decode_attention_ref(q, k, v, pos, stored & every_other), kind,
        f"decode_attention at the {label}")
    del got, want
    ms = time_ms(lambda: decode_attention(*args))
    trace_ms, _ = device_ms(lambda: decode_attention(*args))
    plain_ms = time_ms(lambda: decode_attention_ref(*args), 5, 1)
    live = ring_live(pos, stored)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kw = {"enable_gqa": True} if nq != nkv else {}
    if not bool(live.all()):
        kw["attn_mask"] = live[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, **kw)
    library_ms = time_ms(sdpa)
    sdpa_trace_ms, lib_kernels = device_ms(sdpa)
    n_live = int(live.sum())
    item = q.element_size()
    bound_ms, bound_by = bound(
        2 * q.numel() * item + 2 * n_live * nkv * hd * item + 4 * b + b * w,
        4 * hd * n_live * nq, kind)
    print(f"decode_attention {kind} at the {label} (B={b}, W={w}, nq={nq}, "
          f"nkv={nkv}, hd={hd}, pos {pos.tolist()}, {n_live / b:.0f} live "
          f"slots a row): max abs err {err:.3g} vs the plain version "
          f"(tolerance {TOL[kind]}), scaled max err {rel_max:.3g} (limit "
          f"{FRONTEND_REL_MAX_TOL}) and relative RMS err {rel_rms:.3g} "
          f"(limit {FRONTEND_REL_RMS_TOL}); {controls}; by CUDA events a "
          f"call: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms, kernel/sdpa {ms / library_ms:.2f}; in the "
          f"profiler's trace: kernel {trace_ms:.4f} ms, sdpa "
          f"{sdpa_trace_ms:.4f} ms ({', '.join(x[:40] for x in lib_kernels)}"
          f"), kernel/sdpa {trace_ms / sdpa_trace_ms:.2f}; bound "
          f"{bound_ms:.4f} ms ({bound_by}), kernel/bound "
          f"{ms / bound_ms:.2f} [{gpu}]")
    report["decode_attention"].update({
        f"{prefix}_{key}": val for key, val in dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
            rel_max_err=rel_max, rel_rms_err=rel_rms,
            trace_ms=trace_ms, library_trace_ms=sdpa_trace_ms).items()})


def greedy_steps(serve, params, caches, tok, pos, n):
    """``n`` greedy serve steps, each timed from a synchronise to a
    synchronise; returns (tokens (B, n), ms per step, launches)."""
    import torch
    toks, ms = [], []
    launches = {}
    for _ in range(n):
        (nxt, caches), step_launches, s = counted(serve, params, caches,
                                                  tok, pos)
        add_launches(launches, step_launches)
        ms.append(s * 1e3)
        toks.append(nxt)
        tok, pos = nxt[:, None], pos + 1
    out = torch.stack(toks, 1)
    return out, ms, launches


def check_tokens(toks, vocab, label):
    if int(toks.min()) < 0 or int(toks.max()) >= vocab:
        raise SystemExit(f"{label}: a greedy token is outside [0, {vocab})")


def check_logits(logits, label):
    import torch
    if not torch.isfinite(logits).all():
        raise SystemExit(f"{label}: non-finite logits")


def run_musicgen(dev, gpu, report, total):
    """Phase 19 (a): full-width musicgen-large through the step layer."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import get_shape
    from repro_torch.launch.steps import (LONG_CONTEXT_WINDOW, arch_for_shape,
                                          make_batch, make_step_and_inputs)
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.model import (cache_from_prefill, init_cache,
                                          init_params, prefill)
    from repro_torch.training.optimizer import init_opt_state

    cfg = get_config("musicgen-large")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"musicgen-large: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B bf16 "
          f"params made on the card in {time.perf_counter() - t0:.2f} s")
    phase_memory("musicgen init", dev)

    # ---- prefill_32k ------------------------------------------------
    shape = get_shape("prefill_32k")
    b = FRONTEND_PREFILL_BATCH
    prefill_step, spec = make_step_and_inputs(cfg, shape, batch=b,
                                              device="meta")
    batch = make_batch(cfg, b, shape.seq_len, with_labels=False, device=dev,
                       generator=gen)
    check_like(batch, spec[1], "musicgen prefill_32k")
    rec, flash_calls = record_calls(attn_mod, "flash_attention")
    with rec:
        (last, caches), launches, s = counted(prefill_step, params, batch)
    add_launches(total, launches)
    check_logits(last, "musicgen prefill_32k")
    pfx = batch["prefix_embeds"].shape[1]
    print(f"musicgen prefill_32k: batch {b} x {shape.seq_len} positions "
          f"({pfx} audio prefix embeddings + {shape.seq_len - pfx} tokens) "
          f"through prefill_step: {s * 1e3:.1f} ms (host clock, synchronised,"
          f" the first call at this shape), launches {launches}; last logits "
          f"{tuple(last.shape)} finite [{gpu}]")
    if launches["flash_attention"] != cfg.n_layers:
        raise SystemExit("musicgen prefill_32k: flash_attention launched "
                         f"{launches['flash_attention']} times, not "
                         f"{cfg.n_layers}")
    phase_memory("musicgen prefill_32k", dev)
    check_flash_rows("musicgen_prefill_32k", flash_calls[0][0],
                     flash_calls[0][1].get("window", 0),
                     "musicgen prefill_32k's layer 0", report, gpu)
    del flash_calls, batch
    torch.cuda.empty_cache()
    phase_memory("the flash_attention check at 32k", dev)

    # ---- decode_32k: ring of 32768 slots, 8 greedy steps, twice -----
    dshape = get_shape("decode_32k")
    serve, dspec = make_step_and_inputs(cfg, dshape, batch=b, device="meta")
    ring = init_cache(cfg, b, dshape.seq_len, torch.bfloat16, dev)
    t0 = time.perf_counter()
    cache_from_prefill(cfg, caches, dshape.seq_len, out=ring)
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    check_like(ring, dspec[1], "musicgen decode_32k cache")
    first = torch.argmax(last, -1).to(torch.int32)[:, None]
    pos = torch.full((b,), shape.seq_len, dtype=torch.int32, device=dev)
    rec, dec_calls = record_calls(attn_mod, "decode_attention")
    with rec:
        toks, step_ms, launches = greedy_steps(serve, params, ring, first,
                                               pos, FRONTEND_MG_STEPS)
    add_launches(total, launches)
    check_tokens(toks, cfg.vocab_size, "musicgen decode_32k")
    cache_from_prefill(cfg, caches, dshape.seq_len, out=ring)
    again, _, _ = greedy_steps(serve, params, ring, first, pos,
                               FRONTEND_MG_STEPS)
    same = torch.equal(toks, again)
    print(f"musicgen decode_32k: cache_from_prefill into a {dshape.seq_len}-"
          f"slot ring {ring_ms:.1f} ms, then {FRONTEND_MG_STEPS} greedy "
          f"serve_step calls from position {shape.seq_len}: "
          f"{np.median(step_ms):.2f} ms a step (median; first "
          f"{step_ms[0]:.2f} ms; host clock, synchronised), launches "
          f"{launches}; tokens {toks.tolist()}; a second run from the same "
          f"prefill gives the same tokens bit for bit: {same} [{gpu}]")
    if not same:
        raise SystemExit("musicgen decode_32k: two runs from the same "
                         "prefill differ")
    if launches["decode_attention"] != FRONTEND_MG_STEPS * cfg.n_layers:
        raise SystemExit("musicgen decode_32k: decode_attention launched "
                         f"{launches['decode_attention']} times")
    profile_call(lambda: serve(params, ring, again[:, -1:],
                               pos + FRONTEND_MG_STEPS),
                 "musicgen decode_32k, one more step", gpu)
    phase_memory("musicgen decode_32k", dev)
    del ring, caches, last, toks, again
    torch.cuda.empty_cache()
    check_decode_at("musicgen_decode_32k", dec_calls[0][0],
                    "musicgen decode_32k's layer 0, first step", report, gpu)
    del dec_calls

    # ---- long_500k: a 4096-slot sliding-window ring at 512k ---------
    lshape = get_shape("long_500k")
    wcfg = arch_for_shape(cfg, lshape)
    w = LONG_CONTEXT_WINDOW
    serve_l, lspec = make_step_and_inputs(cfg, lshape, batch=1,
                                          device="meta")
    start = lshape.seq_len - w
    window_toks = torch.randint(1, cfg.vocab_size, (1, w), generator=gen,
                                dtype=torch.int32, device=dev)
    positions = torch.arange(start, lshape.seq_len, dtype=torch.int32,
                             device=dev)
    rec, wflash = record_calls(attn_mod, "flash_attention")
    with rec:
        (wlast, wcaches), launches, s = counted(
            prefill, params, wcfg, window_toks, positions=positions,
            logits_last_only=True)
    add_launches(total, launches)
    check_logits(wlast, "musicgen long_500k window prefill")
    wring = init_cache(wcfg, 1, lshape.seq_len, torch.bfloat16, dev)
    cache_from_prefill(wcfg, wcaches, lshape.seq_len, out=wring)
    check_like(wring, lspec[1], "musicgen long_500k cache")
    del wcaches
    first = torch.argmax(wlast[:, 0], -1).to(torch.int32)[:, None]
    lpos = torch.full((1,), lshape.seq_len, dtype=torch.int32, device=dev)
    rec, ldec = record_calls(attn_mod, "decode_attention")
    with rec:
        ltoks, lstep_ms, llaunches = greedy_steps(
            serve_l, params, wring, first, lpos, FRONTEND_MG_STEPS)
    add_launches(total, llaunches)
    check_tokens(ltoks, cfg.vocab_size, "musicgen long_500k")
    print(f"musicgen long_500k (window {wcfg.sliding_window} by "
          f"arch_for_shape): prefill of positions {start}..."
          f"{lshape.seq_len - 1} {s * 1e3:.1f} ms, launches {launches}; "
          f"{FRONTEND_MG_STEPS} greedy serve_step calls from position "
          f"{lshape.seq_len} on the {w}-slot ring: {np.median(lstep_ms):.2f} "
          f"ms a step (median; host clock, synchronised), launches "
          f"{llaunches}; tokens {ltoks.tolist()} [{gpu}]")
    profile_call(lambda: serve_l(params, wring, ltoks[:, -1:],
                                 lpos + FRONTEND_MG_STEPS),
                 "musicgen long_500k, one more step", gpu)
    phase_memory("musicgen long_500k", dev)
    del wring
    check_flash_rows("musicgen_long_500k_prefill", wflash[0][0],
                     wflash[0][1].get("window", 0),
                     "musicgen long_500k window prefill's layer 0", report,
                     gpu, iters=10)
    check_decode_at("musicgen_long_500k", ldec[0][0],
                    "musicgen long_500k's layer 0, first step", report, gpu)
    del wflash, ldec

    # ---- kernel path against plain path, bf16, S = 2048 -------------
    cb = make_batch(cfg, b, FRONTEND_CHECK_SEQ, with_labels=False,
                    device=dev, generator=gen)
    kern, _ = prefill(params, cfg, cb["tokens"],
                      prefix_embeds=cb["prefix_embeds"],
                      logits_last_only=True)
    plain, _ = prefill(params, cfg, cb["tokens"],
                       prefix_embeds=cb["prefix_embeds"],
                       logits_last_only=True, use_kernels=False)
    kern, plain = kern[:, 0], plain[:, 0]
    check_logits(kern, "musicgen S=2048 kernel path")
    diff = float((kern - plain).abs().max())
    tol = FRONTEND_BF16_REL_TOL * float(plain.abs().max())
    kt, pt = kern.argmax(-1), plain.argmax(-1)
    top2 = plain.topk(2, -1).values
    gaps = (top2[:, 0] - top2[:, 1])[kt != pt]
    print(f"musicgen bf16 prefill at S={FRONTEND_CHECK_SEQ} (batch {b}, "
          f"{cb['prefix_embeds'].shape[1]} prefix positions), kernels "
          f"against use_kernels=False: last logits max abs diff {diff:.4g} "
          f"(tolerance {tol:.4g} = {FRONTEND_BF16_REL_TOL} x max |logit| "
          f"{float(plain.abs().max()):.3g}); greedy tokens {kt.tolist()} vs "
          f"{pt.tolist()}, {int((kt != pt).sum())} differ (top-2 gaps of "
          f"those {gaps.tolist()})")
    if diff > tol or bool((gaps > tol).any()):
        raise SystemExit("musicgen bf16 prefill: the kernel path and the "
                         "plain path differ beyond the tolerance")
    del cb, kern, plain
    phase_memory("the S=2048 kernel/plain prefill", dev)

    # ---- train_4k: 2 donating steps at local batch 1 ----------------
    tshape = get_shape("train_4k")
    train_step, tspec = make_step_and_inputs(cfg, tshape, batch=1,
                                             device="meta")
    gc.collect()
    torch.cuda.empty_cache()
    opt = init_opt_state(params)
    tbatch = make_batch(cfg, 1, tshape.seq_len, with_labels=True, device=dev,
                        generator=gen)
    check_like(tbatch, tspec[2], "musicgen train_4k batch")
    check_like(opt.master, tspec[1].master, "musicgen train_4k optimizer")
    watch = {"embed": params["embed"]["table"],
             "wq": params["blocks"]["pos0"]["attn"]["wq"],
             "down": params["blocks"]["pos0"]["mlp"]["down"]}
    before = {k: t.clone() for k, t in watch.items()}
    phase_memory("musicgen train set-up (params + f32 master, m, v)", dev)
    losses = []
    for i in range(FRONTEND_TRAIN_STEPS):
        (params, opt, metrics), launches, s = counted(train_step, params,
                                                      opt, tbatch)
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        print(f"musicgen train_4k step {i}: batch 1 x {tshape.seq_len} "
              f"({int((~tbatch['loss_mask']).sum())} prefix positions out of "
              f"the loss), donating: {s * 1e3:.1f} ms (host clock, "
              f"synchronised), loss {m['loss']:.4f}, acc {m['acc']:.4f}, "
              f"grad norm {m['grad_norm']:.4f}, lr {m['lr']:.3g}; peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB [{gpu}]")
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            raise SystemExit("musicgen train_4k: a non-finite loss or grad "
                             "norm")
    params, opt, _ = profile_call(
        lambda: train_step(params, opt, tbatch),
        "musicgen train_4k, one more step", gpu)
    moved = {k: float((watch[k].float() - before[k].float()).abs().max())
             for k in watch}
    same = all(watch[k] is t for k, t in (
        ("embed", params["embed"]["table"]),
        ("wq", params["blocks"]["pos0"]["attn"]["wq"])))
    print(f"musicgen train_4k: largest change of the watched params {moved};"
          f" updated in their own tensors: {same}")
    if not all(v > 0 for v in moved.values()) or not same:
        raise SystemExit("musicgen train_4k: the params did not move in "
                         "place")
    phase_memory("musicgen train_4k", dev)
    del params, opt, tbatch, watch, before


def run_llava(dev, gpu, report, total):
    """Phase 19 (b): full-width llava-next-34b, one image request."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.steps import make_batch, make_step_and_inputs
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.frontend import frontend_prefix_len
    from repro_torch.models.model import cache_from_prefill, init_cache, \
        init_params

    cfg = get_config("llava-next-34b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    free, total_mem = torch.cuda.mem_get_info(dev)
    print(f"llava-next-34b: {free / 1e9:.2f} GB free of "
          f"{total_mem / 1e9:.2f} GB before init; needs "
          f"{cfg.param_count() * 2 / 1e9:.2f} GB of bf16 params")
    t0 = time.perf_counter()
    params = init_params(cfg, gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"llava-next-34b: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B bf16 "
          f"params made on the card in {time.perf_counter() - t0:.2f} s")
    phase_memory("llava init", dev)
    s = LLAVA_SEQ
    pshape = InputShape("image_request", s, 1, "prefill")
    prefill_step, spec = make_step_and_inputs(cfg, pshape, device="meta")
    batch = make_batch(cfg, 1, s, with_labels=False, device=dev,
                       generator=gen)
    check_like(batch, spec[1], "llava prefill")
    pfx = frontend_prefix_len(cfg, s)
    rec, flash_calls = record_calls(attn_mod, "flash_attention")
    with rec:
        (last, caches), launches, sec = counted(prefill_step, params, batch)
    add_launches(total, launches)
    check_logits(last, "llava prefill")
    print(f"llava-next-34b prefill: one image request, {pfx} patch "
          f"embeddings + {s - pfx} text tokens = {s} positions, "
          f"{sec * 1e3:.1f} ms (host clock, synchronised, the first call), "
          f"launches {launches} [{gpu}]")
    phase_memory("llava prefill", dev)
    del caches
    last, caches = profile_call(lambda: prefill_step(params, batch),
                                "llava prefill, a second call", gpu)
    cap = s + LLAVA_STEPS
    dshape = InputShape("image_decode", cap, 1, "decode")
    serve, dspec = make_step_and_inputs(cfg, dshape, device="meta")
    ring = init_cache(cfg, 1, cap, torch.bfloat16, dev)
    cache_from_prefill(cfg, caches, cap, out=ring)
    check_like(ring, dspec[1], "llava decode cache")
    del caches
    first = torch.argmax(last, -1).to(torch.int32)[:, None]
    pos = torch.full((1,), s, dtype=torch.int32, device=dev)
    rec, dec_calls = record_calls(attn_mod, "decode_attention")
    with rec:
        toks, step_ms, dlaunches = greedy_steps(serve, params, ring, first,
                                                pos, LLAVA_STEPS)
    add_launches(total, dlaunches)
    check_tokens(toks, cfg.vocab_size, "llava decode")
    print(f"llava-next-34b decode: {LLAVA_STEPS} greedy serve_step calls "
          f"on a {cap}-slot ring from position {s}: {np.median(step_ms):.2f} "
          f"ms a step (median; first {step_ms[0]:.2f} ms; host clock, "
          f"synchronised), launches {dlaunches}; tokens {toks.tolist()} "
          f"[{gpu}]")
    profile_call(lambda: serve(params, ring, toks[:, -1:],
                               pos + LLAVA_STEPS),
                 "llava decode, one more step", gpu)
    phase_memory("llava decode", dev)
    del ring
    check_flash_rows("llava_prefill", flash_calls[0][0],
                     flash_calls[0][1].get("window", 0),
                     "llava prefill's layer 0", report, gpu)
    check_decode_at("llava_decode", dec_calls[0][0],
                    "llava decode's layer 0, first step", report, gpu)
    del params, flash_calls, dec_calls


def run_frontend_archs(dev, gpu, report):
    """Phase 19: the two frontend archs at full width through the step
    layer (``launch/steps.py``): (a) musicgen-large's prefill_32k,
    decode_32k, long_500k and train_4k at local batches, (b) one
    llava-next-34b image request prefilled and decoded. Returns the
    kernels' launches in those runs."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total_mem = torch.cuda.mem_get_info(dev)
    print(f"frontend phase: torch.cuda.mem_get_info() = ({free}, "
          f"{total_mem}): {free / 1e9:.2f} GB free of {total_mem / 1e9:.2f} "
          f"GB, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated "
          f"by this process")
    torch.cuda.reset_peak_memory_stats(dev)
    total = dict.fromkeys(FRONTEND_KERNELS, 0)
    run_musicgen(dev, gpu, report, total)
    gc.collect()
    torch.cuda.empty_cache()
    run_llava(dev, gpu, report, total)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"time frontend phase: {time.perf_counter() - t_phase:.1f} s "
          f"(host clock); launches {total} [{gpu}]")
    return total


# ----------------------------------------------------------------------
# Phase 20: the device mesh
# ----------------------------------------------------------------------

# the collectives timed by CollectiveClock: at their source, through
# which the models' and the engine's wrappers (reduce_sum, gather_whole,
# gather_part, gather_rows) call them, and where a module calls one by
# its own name
COLLECTIVE_SITES = (
    ("repro_torch.sharding.local", ("all_gather", "all_reduce")),
    ("repro_torch.models.attention", ("all_gather",)),
    ("repro_torch.launch.steps", ("all_gather",)))


class CollectiveClock:
    """Host-clock ms of the mesh's collectives by kind ("all_reduce
    model", "all_gather data", ...), each call between two device
    synchronises; a collective over a one-rank axis (an identity) is not
    counted."""

    def __init__(self):
        self.ms, self.calls = {}, {}

    def _wrap(self, name, fn):
        import torch
        from repro_torch.sharding.local import group_size

        def timed(x, mesh, *args, **kwargs):
            axis = args[0] if args else kwargs.get("axis", "model")
            if group_size(mesh, axis) == 1:
                return fn(x, mesh, *args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, mesh, *args, **kwargs)
            torch.cuda.synchronize()
            kind = f"{name} {axis}"
            self.ms[kind] = self.ms.get(kind, 0.0) + \
                (time.perf_counter() - t0) * 1e3
            self.calls[kind] = self.calls.get(kind, 0) + 1
            return out
        return timed

    def patches(self):
        import importlib
        out = []
        for module, names in COLLECTIVE_SITES:
            mod = importlib.import_module(module)
            out += [mock.patch.object(mod, n, self._wrap(n, getattr(mod, n)))
                    for n in names]
        return out


def mesh_users(injector, now, n=MESH_USERS):
    """Phase 20's ``n`` hit users and ``n`` miss users (each with fresh
    events), the same in every process."""
    rng = np.random.RandomState(SEED + 20)
    hit = fresh_users(injector, now, rng, n)
    return hit, fresh_users(injector, now, rng, n, exclude=hit)


def mesh_gateways(eng, injector, hit_users, miss_users, now, label, gpu,
                  clock=False):
    """Each of MESH_BACKENDS behind a Gateway over ``eng``: warm the hit
    users, a hit wave (all hits on the inject path) and a miss wave (all
    prefills), phases timed. With ``clock`` the hit wave runs once more
    with the collectives timed. Returns {backend: (tickets, stats,
    {wave: ms per pane by phase}, collective ms per pane and share)} and
    the kernels' launches."""
    from repro_torch.serving import Gateway

    launches = dict.fromkeys(MESH_KERNELS, 0)
    runs = {}
    for backend in MESH_BACKENDS:
        gw = Gateway(eng, injector, gateway_config(backend,
                                                   GW_CACHE_ENTRIES))
        name = f"{label} {backend}"
        n = gateway_warm(gw, hit_users, now, name, gpu, MESH_KERNELS)
        phases = {}
        waves = []
        for wave, users in (("hit", hit_users), ("miss", miss_users)):
            pc = PhaseClock()
            tickets, n_w, elapsed, delta = gateway_wave(
                gw, users, now, f"{name} {wave}", gpu, clock=pc)
            want = "hits" if wave == "hit" else "misses"
            if delta[want] != len(users):
                raise SystemExit(f"phase 20 {name} {wave} wave: "
                                 f"{delta[want]} {want} of {len(users)}")
            panes = -(-len(users) // eng.scfg.max_batch)
            phases[wave] = dict({k: v / panes for k, v in pc.ms.items()},
                                total=elapsed * 1e3 / panes)
            waves += tickets
            for k in launches:
                launches[k] += n_w[k]
        for k in launches:
            launches[k] += n[k]
        shares = None
        if clock:
            cc = CollectiveClock()
            with contextlib.ExitStack() as stack:
                for patch in cc.patches():
                    stack.enter_context(patch)
                _, _, elapsed, _ = gateway_wave(
                    gw, hit_users, now, f"{name} hit (collectives timed)",
                    gpu)
            panes = -(-len(hit_users) // eng.scfg.max_batch)
            shares = {k: (v / panes, v / (elapsed * 1e3))
                      for k, v in cc.ms.items()}
            print(f"{name} hit wave collectives, ms per pane and "
                  f"share of the wave (host clock, each between device "
                  f"synchronises): " + (", ".join(
                      f"{k} {ms:.3f} ({sh:.1%}, {cc.calls[k]} calls)"
                      for k, (ms, sh) in shares.items()) or "none")
                  + f" [{gpu}]")
        runs[backend] = (waves, gw.stats(), phases, shares)
    return runs, launches


def run_mesh_1x1(dev, gpu, plat, params, now):
    """Phase 20 (a): the sharded code path on a 1x1 NCCL mesh in this
    process. itfi's Gateway at full width (pane 256, bf16) from the host
    LRU and then the pool, on the mesh-free engine and on the 1x1 mesh's
    engine: every response bit for bit, every counter equal. Returns the
    mesh engine's launches."""
    import torch
    from repro_torch.launch.mesh import close_mesh, make_serving_mesh
    from repro_torch.serving import ServingConfig, ServingEngine

    t0 = time.perf_counter()
    mesh = make_serving_mesh(1, 1, device=dev)
    try:
        scfg = ServingConfig(max_batch=SERVE_BATCH, prefill_len=PANE_PREFILL,
                             inject_len=PANE_INJECT,
                             cache_capacity=PANE_CAPACITY)
        cfg = plat.model_cfg
        hit, miss = mesh_users(plat.injector, now)
        runs = {}
        for label, m in (("mesh-free", None), ("1x1 mesh", mesh)):
            eng = ServingEngine(cfg, params, scfg, device=dev, mesh=m)
            runs[label], n = mesh_gateways(eng, plat.injector, hit, miss,
                                           now, f"phase 20 {label}", gpu)
            del eng
            torch.cuda.empty_cache()
        for backend in MESH_BACKENDS:
            want, want_st = runs["mesh-free"][backend][:2]
            got, got_st = runs["1x1 mesh"][backend][:2]
            for a, b in zip(want, got):
                if not (np.array_equal(a.response.slate, b.response.slate)
                        and np.array_equal(a.response.scores,
                                           b.response.scores)):
                    raise SystemExit(f"phase 20 {backend}: a 1x1 mesh "
                                     f"response differs from the mesh-free "
                                     f"one")
            if want_st != got_st:
                raise SystemExit(f"phase 20 {backend}: the 1x1 mesh's "
                                 f"counters differ\n{want_st}\n{got_st}")
            check_gateway_slates(got, cfg.vocab_size, f"1x1 {backend}")
        print(f"phase 20 (a): itfi Gateway on a 1x1 NCCL mesh, host LRU and "
              f"pool, {2 * MESH_USERS} responses each bit for bit the "
              f"mesh-free Gateway's, every counter equal; launches {n}; "
              f"{time.perf_counter() - t0:.1f} s [{gpu}]")
    finally:
        close_mesh()
    return n


def _quiet_ranks():
    """Only rank 0 of a spawned mesh prints."""
    import torch.distributed as dist
    if dist.get_rank() != 0:
        sys.stdout = open(os.devnull, "w")


def mesh_itfi_worker(mesh, device_type, users, batch):
    """Phase 20 (b) on one rank: the full-width itfi Gateway over the
    feature plane, ``users`` a wave in panes of ``batch``, in fp32 (the
    responses, and on a 1x1 mesh each row's smallest pick gap) and then in
    bf16 (phases and collectives timed)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    _quiet_ranks()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    gpu = card() if device_type == "cuda" else "cpu"
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    label = f"phase 20 {sizes['data']}x{sizes['model']}"
    cfg = get_config("itfi-ranker")
    injector, _, _ = build_feature_plane(dev, cfg)
    now = 30 * DAY + 7200 + 60
    hit, miss = mesh_users(injector, now, users)
    scfg = ServingConfig(max_batch=batch, prefill_len=PANE_PREFILL,
                         inject_len=PANE_INJECT, cache_capacity=PANE_CAPACITY)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        kind = str(dtype).split(".")[1]
        params = init_params(cfg, torch.Generator().manual_seed(SEED), dtype,
                             dev, mesh=mesh)
        eng = ServingEngine(cfg, params, scfg, device=dev, mesh=mesh)
        runs, launches = mesh_gateways(eng, injector, hit, miss, now,
                                       f"{label} {kind}", gpu,
                                       clock=dtype == torch.bfloat16)
        out[kind] = {b: {"slates": np.stack([t.response.slate for t in w]),
                         "scores": np.stack([t.response.scores[:cfg.vocab_size]
                                             for t in w]),
                         "paths": [t.response.telemetry.path for t in w],
                         "phases": ph, "collectives": sh}
                     for b, (w, _, ph, sh) in runs.items()}
        out[kind]["launches"] = launches
        if dtype == torch.float32 and mesh.size(0) * mesh.size(1) == 1:
            gaps = []
            for wave in (hit, miss):
                for lo in range(0, len(wave), batch):
                    state, _ = serve_pane(eng, *pane_inputs(
                        eng, injector, wave[lo:lo + batch], now))
                    gaps.append(pick_gaps(eng, state).min(1).values.cpu())
            out["gaps"] = torch.cat(gaps).numpy()
        del eng, params
        if device_type == "cuda":
            torch.cuda.empty_cache()
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                      if device_type == "cuda" else 0.0)
    return out


def mesh_jamba_worker(mesh, device_type, cfg, batch):
    """Phase 20 (b) on one rank: ``cfg`` (jamba-v0.1-52b at full width) in
    bf16 on the mesh through ServingEngine: a sharded init from the seed, a
    warm-up
    pane recording layer 0's kernel inputs, then JAMBA_PANES panes of
    prefill -> inject -> decode_slate timed by phase with their kernel
    launches; rank 0 holds the recorded inputs against the plain versions.
    Returns rank 0's numbers and every rank's peak memory."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counters
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    _quiet_ranks()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    gpu = card() if device_type == "cuda" else "cpu"
    sync = torch.cuda.synchronize if device_type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, torch.bfloat16, dev, mesh=mesh)
    sync()
    init_s = time.perf_counter() - t0
    local_gb = sum(x.nbytes for x in _leaves(params)) / 1e9
    scfg = ServingConfig(max_batch=batch, prefill_len=PANE_PREFILL,
                         inject_len=PANE_INJECT, cache_capacity=PANE_CAPACITY)
    eng = ServingEngine(cfg, params, scfg, device=dev, mesh=mesh)
    del params
    gc.collect()
    init_peak = 0.0
    if device_type == "cuda":
        init_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    print(f"phase 20 jamba: {cfg.name} on a {mesh.size(0)}x{mesh.size(1)} "
          f"mesh, sharded bf16 init from seed {SEED} in {init_s:.1f} s, "
          f"{local_gb:.3f} GB of params a rank, peak {init_peak:.2f} GB "
          f"through the init and the engine's copy; ServingEngine(max_batch="
          f"{batch}, prefill {PANE_PREFILL}, inject {PANE_INJECT}, capacity "
          f"{PANE_CAPACITY}), slate {SLATE_LEN}; graph slates "
          f"{eng.graph_slates} [{gpu}]")
    rng = np.random.RandomState(SEED + 21)
    panes = []
    for _ in range(JAMBA_PANES + 1):
        hists = [list(rng.randint(1, cfg.vocab_size, rng.randint(
            PANE_PREFILL // 2, PANE_PREFILL + 1))) for _ in range(batch)]
        fresh = [list(rng.randint(1, cfg.vocab_size, rng.randint(
            1, PANE_INJECT + 1))) for _ in range(batch)]
        panes.append((eng.pad_tokens(hists, PANE_PREFILL),
                      eng.pad_tokens(fresh, PANE_INJECT, align="left")))

    def pane(inputs, times=None):
        (toks, valid), (stoks, svalid) = inputs
        marks = [time.perf_counter()]

        def mark():
            sync()
            marks.append(time.perf_counter())
        state = eng.prefill(toks, valid, logits_last_only=True)
        mark()
        state = eng.inject(state, stoks, svalid,
                           fallback_logits=state["logits"][:, -1])
        mark()
        slate = eng.decode_slate(state, state["first_logits"], SLATE_LEN)
        mark()
        if times is not None:
            for name, a, b in zip(("prefill", "inject", "decode_slate"),
                                  marks, marks[1:]):
                times.setdefault(name, []).append((b - a) * 1e3)
        return slate

    rec_fa, fa_calls = record_calls(attn_mod, "flash_attention")
    rec_da, da_calls = record_calls(attn_mod, "decode_attention")
    rec_ssd, ssd_calls = record_calls(ssm_mod, "ssd_scan")
    with rec_fa, rec_da, rec_ssd:
        pane(panes[0])
    sync()
    ops = launch_counters()
    for op in ops.values():
        op.launches = 0
    times = {}
    t0 = time.perf_counter()
    slates = [pane(p, times) for p in panes[1:]]
    elapsed = time.perf_counter() - t0
    launches = {n: ops[n].launches for n in JAMBA_KERNELS}
    for s in slates:
        if s.shape != (batch, SLATE_LEN) or s.min() < 0 \
                or s.max() >= cfg.vocab_size \
                or any(len(set(r.tolist())) != SLATE_LEN for r in s):
            raise SystemExit(f"phase 20 jamba: a bad slate, shape {s.shape}")
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if device_type == "cuda" else 0.0)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    phases = {k: float(np.mean(v)) for k, v in times.items()}
    print(f"time phase 20 jamba bf16: {JAMBA_PANES} panes of {batch} in "
          f"{elapsed:.2f} s, ms a pane: " + ", ".join(
              f"{k} {v:.1f} (runs {', '.join(f'{x:.1f}' for x in times[k])})"
              for k, v in phases.items())
          + f"; launches {launches}; peak memory a rank {peaks} GB "
          f"(host clock, synchronised) [{gpu}]")
    if min(launches.values()) <= 0:
        raise SystemExit(f"phase 20 jamba: a kernel never launched: "
                         f"{launches}")
    checks = {}
    if dist.get_rank() == 0 and device_type == "cuda":
        report = {"flash_attention": {}, "decode_attention": {}}
        check_flash_rows("jamba", fa_calls[0][0], cfg.sliding_window,
                         "jamba layer-3 (first attention) prefill, rank 0 "
                         "shard", report, gpu)
        check_decode_at("jamba", da_calls[0][0], "jamba layer-3 decode, "
                        "rank 0 shard", report, gpu)
        args, kwargs = ssd_calls[0]
        checks["ssd_scan"] = check_ssd_at(args, kwargs, "jamba layer-0 "
                                          "prefill, rank 0 shard", gpu)
        checks.update({k: {"ms": v["jamba_ms"], "plain_ms":
                           v["jamba_plain_ms"], "max_abs_err":
                           v["jamba_max_abs_err"]}
                       for k, v in report.items()})
    dist.barrier()
    return {"phases": phases, "launches": launches, "peaks": peaks,
            "init_s": init_s, "init_peak": init_peak, "local_gb": local_gb,
            "checks": checks}


def check_ssd_at(args, kwargs, label, gpu):
    """ssd_scan at a recorded call against the plain version (y and the
    final state held to ``assert_scaled``), then timed."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    kind = str(args[0].dtype).split(".")[1]
    y, h = ssd_scan(*args, **kwargs)
    want_y, want_h = ssd_plain(*args, **kwargs)
    torch.cuda.synchronize()
    err = max(float((y.float() - want_y.float()).abs().max()),
              float((h.float() - want_h.float()).abs().max()))
    assert_scaled(y, want_y, kind, f"ssd_scan at the {label} (y)")
    assert_scaled(h, want_h, "float32" if h.dtype == torch.float32 else kind,
                  f"ssd_scan at the {label} (state)")
    ms, plain_ms, bound_ms, bound_by = time_ssd_scan(args, kwargs, label, gpu)
    print(f"ssd_scan {kind} at the {label}: max abs err {err:.3g} vs the "
          f"plain version (tolerance {TOL[kind]}) [{gpu}]")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}


def _first_flip_ok(want, got, gaps, label):
    """Rows whose slates differ between two fp32 runs: each must have a
    pick gap within E2E_TOL in the reference. Returns the differing
    rows' count."""
    rows = np.flatnonzero((want != got).any(1))
    bad = [int(r) for r in rows if gaps[r] > E2E_TOL]
    if bad:
        raise SystemExit(f"{label}: {len(bad)} slates differ on rows whose "
                         f"picks are separated by more than {E2E_TOL}: "
                         f"rows {bad[:8]}, gaps {[float(gaps[r]) for r in bad[:8]]}")
    return len(rows)


def run_mesh_cards(gpu, device_type="cuda"):
    """Phase 20 (b), with at least four cards: itfi's Gateway at full width
    on 1x1, 4x1 and 2x2 NCCL meshes (fp32 responses of 4x1 and 2x2 against
    1x1's, bf16 timed by phase and collective), then jamba-v0.1-52b at full
    width on 1x4. Returns the meshes' kernel launches."""
    import gc

    import torch
    from repro_torch.launch.mesh import run_on_mesh

    cards = torch.cuda.device_count() if device_type == "cuda" else 4
    if cards < 4:
        print(f"phase 20 (b): not run: it needs 4 cards and this machine "
              f"has {cards} (torch.cuda.device_count()); the itfi 4x1 and "
              f"2x2 meshes and jamba-v0.1-52b on 1x4 run on four cards")
        return {}
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = dict.fromkeys(JAMBA_KERNELS, 0)
    results = {}
    for shape in ((1, 1),) + MESH_SHAPES:
        t1 = time.perf_counter()
        results[shape] = run_on_mesh(*shape, mesh_itfi_worker, device_type,
                                     MESH_USERS, SERVE_BATCH,
                                     device=device_type, timeout_s=600)
        print(f"phase 20 itfi {shape[0]}x{shape[1]}: "
              f"{time.perf_counter() - t1:.1f} s with its processes' start "
              f"[{gpu}]")
        for kind in ("float32", "bfloat16"):
            for k, v in results[shape][kind]["launches"].items():
                launches[k] += v
    ref = results[(1, 1)]["float32"]
    gaps = results[(1, 1)]["gaps"]
    for shape in MESH_SHAPES:
        name = f"{shape[0]}x{shape[1]}"
        for backend in MESH_BACKENDS:
            want, got = ref[backend], results[shape]["float32"][backend]
            if want["paths"] != got["paths"]:
                raise SystemExit(f"phase 20 {name} {backend}: paths differ")
            err = float(np.abs(want["scores"] - got["scores"]).max())
            if err > E2E_TOL:
                raise SystemExit(f"phase 20 {name} {backend}: scores max abs "
                                 f"err {err:.3g} over {E2E_TOL}")
            flips = _first_flip_ok(want["slates"], got["slates"], gaps,
                                   f"phase 20 {name} {backend}")
            print(f"phase 20 fp32 itfi Gateway {name} vs 1x1, {backend}: "
                  f"{len(gaps)} responses, scores max abs err {err:.3g} "
                  f"(tolerance {E2E_TOL}), {flips} slates differ, each on a "
                  f"row whose picks tie within {E2E_TOL} [{gpu}]")
    for shape, res in results.items():
        for backend in MESH_BACKENDS:
            ph = res["bfloat16"][backend]["phases"]
            sh = res["bfloat16"][backend]["collectives"] or {}
            print(f"phase 20 bf16 itfi Gateway {shape[0]}x{shape[1]} "
                  f"{backend}, ms a pane of {SERVE_BATCH} by phase: " +
                  "; ".join(f"{w} " + ", ".join(f"{k} {v:.3f}"
                                                for k, v in p.items())
                            for w, p in ph.items())
                  + "; collectives in the hit wave: " + (", ".join(
                      f"{k} {ms:.3f} ms ({s:.1%})"
                      for k, (ms, s) in sh.items()) or "none")
                  + f"; peak {res['peak_gb']:.2f} GB a rank [{gpu}]")
    t1 = time.perf_counter()
    from repro_torch.configs import get_config
    jam = run_on_mesh(*JAMBA_MESH, mesh_jamba_worker, device_type,
                      get_config(JAMBA_ARCH), JAMBA_BATCH,
                      device=device_type, timeout_s=900)
    for k, v in jam["launches"].items():
        launches[k] += v
    print(f"phase 20 jamba {JAMBA_MESH[0]}x{JAMBA_MESH[1]}: "
          f"{time.perf_counter() - t1:.1f} s with its processes' start; "
          f"ms a pane of {JAMBA_BATCH}: " + ", ".join(
              f"{k} {v:.1f}" for k, v in jam["phases"].items())
          + f"; peak memory a rank {[round(p, 2) for p in jam['peaks']]} "
          f"GB; kernels at rank 0's layer inputs {jam['checks']} [{gpu}]")
    print(f"time phase 20 (b): {time.perf_counter() - t0:.1f} s; launches "
          f"{launches} [{gpu}]")
    return launches


# ----------------------------------------------------------------------
# Phase 21: the step layer on a mesh
# ----------------------------------------------------------------------

def steps_shapes():
    """Phase 21's input shapes: the train, prefill and decode shapes of
    (a) and (b)."""
    from repro_torch.configs import InputShape, get_shape
    return {"train": get_shape("train_4k"),
            "prefill": InputShape("prefill_4k", STEPS_PREFILL_SEQ, 1,
                                  "prefill"),
            "decode": get_shape("decode_32k")}


def steps_config(arch):
    """The registered config of ``arch`` at full width."""
    from repro_torch.configs import get_config
    return get_config(arch)


def _timed(fn, *args, sync=None):
    """``fn(*args)`` from a device synchronise to a device synchronise:
    (result, ms)."""
    import torch
    sync = sync or torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    out = fn(*args)
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def _seeded(dev):
    import torch
    return torch.Generator(device=dev).manual_seed(SEED)


def _bitwise(got, want, label):
    """Every leaf of ``got`` bit for bit the matching leaf of ``want``;
    returns the leaves compared."""
    import torch
    from repro_torch.models.common import flatten_with_keystr
    g, w = flatten_with_keystr(got), flatten_with_keystr(want)
    if [p for p, _ in g] != [p for p, _ in w]:
        raise SystemExit(f"{label}: the trees differ")
    for (path, x), (_, y) in zip(g, w):
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
            raise SystemExit(f"{label}: {path} differs from the mesh-free "
                             f"step's")
    return len(g)


def run_steps_1x1(dev, gpu, report):
    """Phase 21 (a): full-width ``llama3.2-1b`` (bf16 from the seed)
    through ``make_step_and_specs`` on a 1x1 NCCL mesh in this process,
    each step kind against ``make_step_and_inputs``' one-device step from
    the same seed on its own copy: two donating ``train_4k`` steps at
    local batch 1 (every metric and every updated leaf of the params and
    the optimizer state bit for bit), a prefill at S 4096, batch 1 (the
    last logits and every cache leaf) and a ``decode_32k`` step at batch
    1 (the token and every cache leaf). The mesh steps' layer-0
    ``flash_attention`` and ``decode_attention`` inputs are then held
    against the plain versions, with their times and bounds in
    ``report``. Returns the mesh steps' kernel launches."""
    import gc

    import torch
    from repro_torch.launch.mesh import close_mesh, make_serving_mesh
    from repro_torch.launch.steps import (make_step_and_inputs,
                                          make_step_and_specs)
    from repro_torch.models import attention as attn_mod

    t0 = time.perf_counter()
    cfg = steps_config(STEPS_ARCH)
    shapes = steps_shapes()
    ops = kernel_ops(STEPS_KERNELS)
    launches = dict.fromkeys(STEPS_KERNELS, 0)
    mesh = make_serving_mesh(1, 1, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        # ---- train_4k: two donating steps each ----------------------
        step, args = make_step_and_inputs(cfg, shapes["train"], batch=1,
                                          device=dev, generator=_seeded(dev))
        free_ms, free_metrics = [], []
        for _ in range(STEPS_TRAIN_STEPS):
            (p, o, m), ms = _timed(step, *args)
            args = (p, o, args[2])
            free_ms.append(ms)
            free_metrics.append(m)
        want = args[:2]
        del step, args, p, o
        mstep, margs, ins, outs = make_step_and_specs(
            cfg, shapes["train"], mesh, batch=1, device=dev,
            generator=_seeded(dev))
        mesh_ms, mesh_metrics = [], []
        for _ in range(STEPS_TRAIN_STEPS):
            for op in ops.values():
                op.launches = 0
            (p, o, m), ms = _timed(mstep, *margs)
            add_launches(launches, {n: op.launches for n, op in ops.items()})
            margs = (p, o, margs[2])
            mesh_ms.append(ms)
            mesh_metrics.append(m)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        n = _bitwise(list(margs[:2]), list(want), "phase 21 (a) train_4k")
        for i, (a, b) in enumerate(zip(mesh_metrics, free_metrics)):
            _bitwise(a, b, f"phase 21 (a) train_4k step {i} metrics")
        print(f"phase 21 (a) {cfg.name} train_4k, batch 1 x "
              f"{shapes['train'].seq_len}, two donating steps on a 1x1 NCCL "
              f"mesh: {n} leaves of params and optimizer state and every "
              f"metric bit for bit the mesh-free steps'; losses "
              f"{[round(float(m['loss']), 6) for m in mesh_metrics]}, grad "
              f"norms {[round(float(m['grad_norm']), 6) for m in mesh_metrics]}"
              f"; ms a step: mesh {[round(x, 1) for x in mesh_ms]}, "
              f"mesh-free {[round(x, 1) for x in free_ms]} (host clock, "
              f"synchronised); peak {peak:.2f} GB with both copies held "
              f"[{gpu}]")
        del want, margs, mstep, p, o
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

        # ---- prefill at S 4096 and decode_32k, batch 1 --------------
        recorded = {"prefill": "flash_attention",
                    "decode": "decode_attention"}
        for kind in ("prefill", "decode"):
            step, args = make_step_and_inputs(cfg, shapes[kind], batch=1,
                                              device=dev,
                                              generator=_seeded(dev))
            want, free_ms = _timed(step, *args)
            del step, args
            mstep, margs, _, _ = make_step_and_specs(
                cfg, shapes[kind], mesh, batch=1, device=dev,
                generator=_seeded(dev))
            rec, calls = record_calls(attn_mod, recorded[kind])
            for op in ops.values():
                op.launches = 0
            with rec:
                got, ms = _timed(mstep, *margs)
            n_k = {n: op.launches for n, op in ops.items()}
            add_launches(launches, n_k)
            n = _bitwise(list(got), list(want), f"phase 21 (a) {kind}")
            if kind == "prefill":
                check_logits(got[0], "phase 21 (a) prefill")
            else:
                check_tokens(got[0][:, None], cfg.vocab_size,
                             "phase 21 (a) decode")
            print(f"phase 21 (a) {cfg.name} {shapes[kind].name} "
                  f"(S {shapes[kind].seq_len}, batch 1) on the 1x1 mesh: "
                  f"{n} outputs bit for bit the mesh-free step's; mesh "
                  f"{ms:.1f} ms, mesh-free {free_ms:.1f} ms (host clock, "
                  f"synchronised, first call); launches {n_k}; peak "
                  f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
                  f"[{gpu}]")
            del want, got, margs, mstep
            gc.collect()
            torch.cuda.empty_cache()
            if kind == "prefill":
                check_flash_rows("llama_prefill", calls[0][0],
                                 cfg.sliding_window, "llama3.2-1b layer-0 "
                                 "prefill on the 1x1 mesh", report, gpu)
            else:
                check_decode_at("llama_decode_32k", calls[0][0],
                                "llama3.2-1b layer-0 decode_32k on the 1x1 "
                                "mesh", report, gpu)
            del calls, rec
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    finally:
        close_mesh()
    if min(launches.values()) <= 0:
        raise SystemExit(f"phase 21 (a): a kernel never launched: {launches}")
    print(f"time phase 21 (a): {time.perf_counter() - t0:.1f} s; launches "
          f"{launches} [{gpu}]")
    return launches


def _rank_device(device_type):
    import torch
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _rank_peak(dev, device_type):
    import torch
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if device_type == "cuda" else 0.0)


def steps_llama_worker(mesh, device_type):
    """Phase 21 (b) 1 on one rank: ``llama3.2-1b`` in fp32, one
    ``train_4k`` step at a global batch of STEPS_CARDS_BATCH on this mesh
    (``make_step_and_specs``' args, AdamW eps 1e-3), against the mesh-free
    step from the same seed on the rank's own card, of which the rank
    keeps only its blocks: loss and grad norm relative errors, the
    largest abs error of the rank's blocks of the updated params, and the
    largest error of its blocks of m relative to each leaf's largest |m|,
    over every rank."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.launch.steps import (make_step_and_inputs,
                                          make_step_and_specs)
    from repro_torch.models.common import flatten_with_keystr
    from repro_torch.sharding.local import shard_tree
    from repro_torch.sharding.rules import param_pspecs
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    _quiet_ranks()
    dev = _rank_device(device_type)
    sync = torch.cuda.synchronize if device_type == "cuda" else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = steps_config(STEPS_ARCH)
    shape = steps_shapes()["train"]
    b = STEPS_CARDS_BATCH
    adamw = AdamWConfig(lr=1e-3, warmup_steps=0, eps=1e-3)
    specs = param_pspecs(cfg, mesh)
    _, args = make_step_and_inputs(cfg, shape, batch=b, device=dev,
                                   dtype=torch.float32,
                                   generator=_seeded(dev))
    ref = make_train_step(cfg, TrainConfig(adamw=adamw, remat=True,
                                           param_dtype=torch.float32),
                          donate=True)
    (p, o, want), ref_ms = _timed(ref, *args, sync=sync)
    want = {k: float(v) for k, v in want.items()}
    keep = {"params": shard_tree(p, specs, mesh),
            "m": shard_tree(o.m, specs, mesh)}
    keep = {k: {path: t.clone() for path, t in flatten_with_keystr(v)}
            for k, v in keep.items()}
    del args, p, o, ref
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    _, margs, ins, _ = make_step_and_specs(cfg, shape, mesh, batch=b,
                                           device=dev, dtype=torch.float32,
                                           generator=_seeded(dev))
    step = make_train_step(cfg, TrainConfig(
        adamw=adamw, remat=True, param_dtype=torch.float32, mesh=mesh),
        donate=True)
    (p, o, got), ms = _timed(step, *margs, sync=sync)
    got = {k: float(v) for k, v in got.items()}
    errs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
            for k in ("loss", "grad_norm")}
    errs["params"] = max(float((t - keep["params"][path]).abs().max())
                         for path, t in flatten_with_keystr(p))
    errs["m"] = max(float((t - keep["m"][path]).abs().max()
                          / keep["m"][path].abs().max().clamp_min(1e-30))
                    for path, t in flatten_with_keystr(o.m))
    peak = _rank_peak(dev, device_type)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (errs, got["loss"], ms, peak))
    worst = {k: max(e[0][k] for e in every) for k in errs}
    return {"errs": worst, "loss": want["loss"], "losses": [e[1] for e in
                                                            every],
            "ms": ms, "ref_ms": ref_ms, "peaks": [e[3] for e in every]}


def steps_codeqwen_worker(mesh, device_type):
    """Phase 21 (b) 2 on one rank: ``codeqwen1.5-7b`` at full width, bf16
    from the seed, through ``make_step_and_specs`` on this mesh: three
    donating ``train_4k`` steps at a global batch of STEPS_BIG_BATCH (loss
    finite and equal on every rank), then a prefill at S 4096 and two
    greedy ``decode_32k`` steps at the same batch, recording layer 0's
    kernel inputs, which rank 0 holds against the plain versions. Returns
    rank 0's numbers and every rank's peak memory."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.launch.steps import make_step_and_specs
    from repro_torch.models import attention as attn_mod

    _quiet_ranks()
    dev = _rank_device(device_type)
    gpu = card() if device_type == "cuda" else "cpu"
    sync = torch.cuda.synchronize if device_type == "cuda" else (lambda: None)
    cfg = steps_config(STEPS_BIG_ARCH)
    shapes = steps_shapes()
    b = STEPS_BIG_BATCH
    ops = kernel_ops(STEPS_KERNELS)
    launches = dict.fromkeys(STEPS_KERNELS, 0)
    sizes = f"{mesh.size(0)}x{mesh.size(1)}"
    t0 = time.perf_counter()
    step, (params, opt, batch), _, _ = make_step_and_specs(
        cfg, shapes["train"], mesh, batch=b, device=dev,
        generator=_seeded(dev))
    sync()
    init_s = time.perf_counter() - t0
    local_gb = sum(x.nbytes for t in (params, opt.master, opt.m, opt.v)
                   for x in _leaves(t)) / 1e9
    losses, step_ms = [], []
    for _ in range(STEPS_BIG_TRAIN_STEPS):
        for op in ops.values():
            op.launches = 0
        (params, opt, m), ms = _timed(step, params, opt, batch, sync=sync)
        add_launches(launches, {n: op.launches for n, op in ops.items()})
        losses.append(float(m["loss"]))
        step_ms.append(ms)
    train_peak = _rank_peak(dev, device_type)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (losses, train_peak))
    if any(e[0] != losses for e in every) or not all(
            math.isfinite(x) for x in losses):
        raise SystemExit(f"phase 21 codeqwen {sizes}: the ranks' losses "
                         f"differ or are not finite: {every}")
    print(f"phase 21 (b) {cfg.name} train_4k on a {sizes} mesh, global batch "
          f"{b} x {shapes['train'].seq_len}, bf16 from seed {SEED}: init "
          f"{init_s:.1f} s, {local_gb:.3f} GB of params and optimizer state "
          f"a rank; losses {losses} (equal on every rank); ms a step "
          f"{[round(x, 1) for x in step_ms]} (host clock, synchronised); "
          f"peak a rank {[round(e[1], 2) for e in every]} GB [{gpu}]")
    del step, params, opt, batch
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    prefill_shape = dataclasses.replace(shapes["prefill"], global_batch=b)
    pstep, pargs, _, _ = make_step_and_specs(cfg, prefill_shape, mesh,
                                             device=dev,
                                             generator=_seeded(dev))
    rec_fa, fa_calls = record_calls(attn_mod, "flash_attention")
    for op in ops.values():
        op.launches = 0
    with rec_fa:
        (logits, _), prefill_ms = _timed(pstep, *pargs, sync=sync)
    add_launches(launches, {n: op.launches for n, op in ops.items()})
    check_logits(logits, f"phase 21 codeqwen {sizes} prefill")
    del pstep, pargs, logits
    gc.collect()
    dstep, (params, caches, tok, pos), _, _ = make_step_and_specs(
        cfg, shapes["decode"], mesh, batch=b, device=dev,
        generator=_seeded(dev))
    rec_da, da_calls = record_calls(attn_mod, "decode_attention")
    decode_ms = []
    for i in range(STEPS_BIG_DECODE_STEPS):
        for op in ops.values():
            op.launches = 0
        with rec_da:
            (nxt, caches), ms = _timed(dstep, params, caches, tok, pos,
                                       sync=sync)
        add_launches(launches, {n: op.launches for n, op in ops.items()})
        check_tokens(nxt[:, None], cfg.vocab_size,
                     f"phase 21 codeqwen {sizes} decode")
        tok, pos = nxt[:, None], pos + 1
        decode_ms.append(ms)
    peak = _rank_peak(dev, device_type)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, (train_peak, peak))
    print(f"time phase 21 (b) {cfg.name} on {sizes}: prefill S "
          f"{shapes['prefill'].seq_len} batch {b} {prefill_ms:.1f} ms, "
          f"decode_32k steps {[round(x, 1) for x in decode_ms]} ms (host "
          f"clock, synchronised); launches {launches}; peak a rank (train, "
          f"serve) {peaks} GB [{gpu}]")
    if min(launches.values()) <= 0:
        raise SystemExit(f"phase 21 codeqwen: a kernel never launched: "
                         f"{launches}")
    checks = {}
    if dist.get_rank() == 0 and device_type == "cuda":
        report = {"flash_attention": {}, "decode_attention": {}}
        check_flash_rows("codeqwen", fa_calls[0][0], cfg.sliding_window,
                         "codeqwen layer-0 prefill, rank 0 shard", report,
                         gpu)
        check_decode_at("codeqwen", da_calls[0][0], "codeqwen layer-0 "
                        "decode, rank 0 shard", report, gpu)
        checks = {k: {"ms": v["codeqwen_ms"],
                      "plain_ms": v["codeqwen_plain_ms"],
                      "max_abs_err": v["codeqwen_max_abs_err"]}
                  for k, v in report.items()}
    dist.barrier()
    return {"losses": losses, "step_ms": step_ms, "init_s": init_s,
            "local_gb": local_gb, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "peaks": peaks, "launches": launches,
            "checks": checks}


def run_steps_cards(gpu, device_type="cuda"):
    """Phase 21 (b), with at least four cards, one process a card:
    ``llama3.2-1b`` in fp32 on 2x2, 1x4 and 4x1 against the mesh-free
    step (loss and grad norm within 1e-4 relative, the updated params
    within STEPS_PARAM_TOL and m within STEPS_M_REL_TOL of each leaf's
    largest |m|), then ``codeqwen1.5-7b`` at full width on 2x2. Returns
    the codeqwen run's launches."""
    import gc

    import torch
    from repro_torch.launch.mesh import run_on_mesh

    cards = torch.cuda.device_count() if device_type == "cuda" else 4
    if cards < 4:
        print(f"phase 21 (b): not run: it needs 4 cards and this machine "
              f"has {cards} (torch.cuda.device_count()); llama3.2-1b's fp32 "
              f"train step on 2x2, 1x4 and 4x1 and codeqwen1.5-7b's "
              f"training on 2x2 run on four cards")
        return {}
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for shape in STEPS_MESHES:
        t1 = time.perf_counter()
        res = run_on_mesh(*shape, steps_llama_worker, device_type,
                          device=device_type, timeout_s=900)
        name = f"{shape[0]}x{shape[1]}"
        e = res["errs"]
        print(f"phase 21 (b) fp32 {STEPS_ARCH} train_4k at {name} against "
              f"the mesh-free step, global batch {STEPS_CARDS_BATCH}: loss "
              f"{res['loss']:.6f}, rel err loss {e['loss']:.3g}, grad norm "
              f"{e['grad_norm']:.3g} (tolerance {E2E_TOL}); max abs err "
              f"params {e['params']:.3g} (tolerance {STEPS_PARAM_TOL}); m's "
              f"max err over its leaf's max |m| {e['m']:.3g} (tolerance "
              f"{STEPS_M_REL_TOL}); ms a step "
              f"{res['ms']:.1f} (mesh-free {res['ref_ms']:.1f}); peak a rank "
              f"{[round(x, 2) for x in res['peaks']]} GB; "
              f"{time.perf_counter() - t1:.1f} s with its processes' start "
              f"[{gpu}]")
        if (max(e["loss"], e["grad_norm"]) > E2E_TOL
                or e["params"] > STEPS_PARAM_TOL or e["m"] > STEPS_M_REL_TOL
                or len(set(res["losses"])) != 1):
            raise SystemExit(f"phase 21 (b) {name}: the mesh step differs "
                             f"from the mesh-free one: {e}, losses "
                             f"{res['losses']}")
    t1 = time.perf_counter()
    big = run_on_mesh(*STEPS_BIG_MESH, steps_codeqwen_worker, device_type,
                      device=device_type, timeout_s=1200)
    print(f"phase 21 (b) {STEPS_BIG_ARCH} {STEPS_BIG_MESH[0]}x"
          f"{STEPS_BIG_MESH[1]}: {time.perf_counter() - t1:.1f} s with its "
          f"processes' start; kernels at rank 0's layer-0 inputs "
          f"{big['checks']} [{gpu}]")
    print(f"time phase 21 (b): {time.perf_counter() - t0:.1f} s; launches "
          f"{big['launches']} [{gpu}]")
    return big["launches"]


# ----------------------------------------------------------------------
# Phase 22: the dry run against the card
# ----------------------------------------------------------------------

def _hide_cards():
    """A dry-run process's initializer: it works on meta tensors only, so
    it keeps off the cards (a CUDA context would take their memory)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _dryrun_kind(arch, kind, mesh_sizes):
    """The dry run (``launch/dryrun.py``'s ``dry_run``, on meta tensors)
    of one of ``arch``'s DRYRUN_KINDS steps at batch 1 on an abstract
    mesh of ``mesh_sizes``."""
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.sharding.rules import MeshShape
    return dry_run(steps_config(arch), steps_shapes()[kind],
                   MeshShape(tuple(mesh_sizes), ("data", "model")), batch=1)


def dryrun_line(est) -> str:
    """A dry run's estimate and roofline terms, for a printed line."""
    m, rt = est["memory"], est["roofline"]
    return (f"estimate {m['peak_bytes_per_device'] / 1e9:.3f} GB (arguments "
            f"{m['argument_bytes_per_device'] / 1e9:.3f} GB), fits "
            f"{est['fits']}; terms compute {rt['compute_s'] * 1e3:.3f} ms, "
            f"memory {rt['memory_s'] * 1e3:.3f} ms, collective "
            f"{rt['collective_s'] * 1e3:.3f} ms (dominant {rt['dominant']}); "
            f"traced in {est['trace_s']:.2f} s")


def check_peak(measured, est, label):
    """``measured`` (bytes) within DRYRUN_PEAK_BAND of the dry run's
    estimate; returns their ratio."""
    ratio = measured / est["memory"]["peak_bytes_per_device"]
    lo, hi = DRYRUN_PEAK_BAND
    if not lo <= ratio <= hi:
        raise SystemExit(f"{label}: measured peak {measured / 1e9:.3f} GB is "
                         f"{ratio:.3f}x the dry run's estimate "
                         f"{est['memory']['peak_bytes_per_device'] / 1e9:.3f}"
                         f" GB, outside {DRYRUN_PEAK_BAND}")
    return ratio


def model_flops_share(est, ms) -> float:
    """The step's model FLOPs over (its seconds x the card's bf16 peak)."""
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    rt = est["roofline"]
    return rt["model_flops"] / rt["chips"] / (ms * 1e-3 * PEAK_FLOPS_BF16)


def _fresh_step(cfg, shape, mesh, dev, sync):
    """A step of ``make_step_and_specs`` at batch 1 from the seed, made
    after freeing what the card caches: (step, args, the bytes allocated
    before its arguments)."""
    import gc

    import torch
    from repro_torch.launch.steps import make_step_and_specs
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    step, args, _, _ = make_step_and_specs(cfg, shape, mesh, batch=1,
                                           device=dev,
                                           generator=_seeded(dev))
    sync()
    # the init's freed draws back to the card, for NCCL's own allocations
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return step, args, base


def _next_args(kind, args, out):
    """The arguments of the step's second call: the updated params and
    optimizer state (train), the same batch (prefill), the next token at
    the next position on the updated caches (decode)."""
    if kind == "train":
        return (out[0], out[1], args[2])
    if kind == "decode":
        return (args[0], out[1], out[0][:, None], args[3] + 1)
    return args


def run_dryrun_1x1(dev, gpu, report):
    """Phase 22 (a): full-width ``llama3.2-1b`` (bf16 from the seed) on a
    1x1 NCCL mesh, its ``train_4k`` step, a prefill at S 4096 and a
    ``decode_32k`` step at batch 1: each first dry-run on meta at exactly
    these arguments, then run on the card from fresh arguments; the
    measured peak (what the card allocated beyond what it held before the
    arguments) within DRYRUN_PEAK_BAND of the estimate. A second call is
    timed beside the roofline's terms, and records layer 0's kernel
    inputs, which are held against the plain versions. Returns the
    steps' kernel launches."""
    import gc

    import torch
    from repro_torch.launch.mesh import close_mesh, make_serving_mesh
    from repro_torch.models import attention as attn_mod

    t0 = time.perf_counter()
    cfg = steps_config(STEPS_ARCH)
    shapes = steps_shapes()
    est = {kind: _dryrun_kind(STEPS_ARCH, kind, (1, 1))
           for kind in DRYRUN_KINDS}
    print(f"phase 22 (a) dry runs of {cfg.name} at batch 1 on a 1x1 mesh in "
          f"{time.perf_counter() - t0:.1f} s on the host")
    ops = kernel_ops(STEPS_KERNELS)
    launches = dict.fromkeys(STEPS_KERNELS, 0)
    recorded = {"prefill": "flash_attention", "decode": "decode_attention"}
    mesh = make_serving_mesh(1, 1, device=dev)
    try:
        for kind in DRYRUN_KINDS:
            label = f"phase 22 (a) {cfg.name} {shapes[kind].name}"
            step, args, base = _fresh_step(cfg, shapes[kind], mesh, dev,
                                           torch.cuda.synchronize)
            for op in ops.values():
                op.launches = 0
            out, ms = _timed(step, *args)
            add_launches(launches, {n: op.launches for n, op in ops.items()})
            measured = torch.cuda.max_memory_allocated(dev) - base
            ratio = check_peak(measured, est[kind], label)
            args = _next_args(kind, args, out)
            del out
            rec = calls = None
            if kind in recorded:
                rec, calls = record_calls(attn_mod, recorded[kind])
            with rec or contextlib.nullcontext():
                for op in ops.values():
                    op.launches = 0
                out, ms2 = _timed(step, *args)
                add_launches(launches,
                             {n: op.launches for n, op in ops.items()})
            if kind == "train":
                check_logits(out[2]["loss"].reshape(1, 1), label)
            elif kind == "prefill":
                check_logits(out[0], label)
            else:
                check_tokens(out[0][:, None], cfg.vocab_size, label)
            print(f"{label} (S {shapes[kind].seq_len}, batch 1): measured "
                  f"peak {measured / 1e9:.3f} GB, {ratio:.3f}x the dry run's "
                  f"{dryrun_line(est[kind])}; ms a step {ms:.1f}, then "
                  f"{ms2:.1f} (host clock, synchronised); model FLOPs over "
                  f"(s x peak) {model_flops_share(est[kind], ms2):.4f} "
                  f"[{gpu}]")
            del step, args, out
            gc.collect()
            torch.cuda.empty_cache()
            if kind == "prefill":
                check_flash_rows("llama_dryrun", calls[0][0],
                                 cfg.sliding_window, "llama3.2-1b layer-0 "
                                 "prefill, phase 22 (a)", report, gpu)
            elif kind == "decode":
                check_decode_at("llama_dryrun", calls[0][0], "llama3.2-1b "
                                "layer-0 decode_32k, phase 22 (a)", report,
                                gpu)
            del calls, rec
    finally:
        close_mesh()
    if min(launches.values()) <= 0:
        raise SystemExit(f"phase 22 (a): a kernel never launched: {launches}")
    print(f"time phase 22 (a): {time.perf_counter() - t0:.1f} s; launches "
          f"{launches} [{gpu}]")
    return launches


def dryrun_cards_worker(mesh, device_type, est):
    """Phase 22 (b) on one rank: each of DRYRUN_CARDS_ARCHS at full width
    (bf16 from the seed) on this mesh, each of its prefill (S 4096) and
    ``decode_32k`` steps at batch 1 that its dry run ``est[arch]`` says
    fits, run from fresh arguments: the rank's peak held to
    DRYRUN_PEAK_BAND of the estimate, the logits finite and the next
    tokens equal on every rank. The prefill's one call, and the second
    of the decode's two (its first carries one-time costs), times each
    collective and records layer 0's kernel inputs, which rank 0 holds
    against the plain versions. Returns rank 0's numbers by arch, every
    rank's peaks among them."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.models import attention as attn_mod
    from repro_torch.sharding.local import all_gather, warm_groups

    _quiet_ranks()
    dev = _rank_device(device_type)
    gpu = card() if device_type == "cuda" else "cpu"
    sync = torch.cuda.synchronize if device_type == "cuda" else (lambda: None)
    shapes = steps_shapes()
    ops = kernel_ops(STEPS_KERNELS)
    recorded = {"prefill": "flash_attention", "decode": "decode_attention"}
    # the communicators' buffers before the params nearly fill the card
    warm_groups(mesh, dev)
    results = {}
    for arch in DRYRUN_CARDS_ARCHS:
        cfg = steps_config(arch)
        res = results[arch] = {"checks": {},
                               "launches": dict.fromkeys(STEPS_KERNELS, 0)}
        for kind in ("prefill", "decode"):
            if not est[arch][kind]["fits"]:
                continue
            label = f"phase 22 (b) {arch} {shapes[kind].name}"
            t0 = time.perf_counter()
            step, args, base = _fresh_step(cfg, shapes[kind], mesh, dev,
                                           sync)
            init_s = time.perf_counter() - t0
            clock = CollectiveClock()
            rec, calls = record_calls(attn_mod, recorded[kind])
            n_calls = 1 if kind == "prefill" else 2
            ms = []
            for i in range(n_calls):
                with contextlib.ExitStack() as stack:
                    if i == n_calls - 1:
                        for patch in clock.patches() + [rec]:
                            stack.enter_context(patch)
                    for op in ops.values():
                        op.launches = 0
                    out, t = _timed(step, *args, sync=sync)
                    add_launches(res["launches"], {n: op.launches
                                                   for n, op in ops.items()})
                ms.append(t)
                if i == 0:
                    measured = torch.cuda.max_memory_allocated(dev) - base
                    peaks = [None] * dist.get_world_size()
                    dist.all_gather_object(peaks, measured)
                    ratios = [check_peak(m, est[arch][kind],
                                         f"{label} rank {r}")
                              for r, m in enumerate(peaks)]
                    if kind == "prefill":
                        check_logits(out[0], label)
                        # the rank's vocab block of the logits, whole
                        toks = torch.argmax(all_gather(
                            out[0].float().contiguous(), mesh, "model",
                            -1), dim=-1)
                    else:
                        toks = out[0]
                    every = [None] * dist.get_world_size()
                    dist.all_gather_object(every, toks.tolist())
                    if any(e != every[0] for e in every):
                        raise SystemExit(f"{label}: the ranks' next tokens "
                                         f"differ: {every}")
                    check_tokens(toks[:, None], cfg.vocab_size, label)
                args = _next_args(kind, args, out)
                del out
            res[kind] = {"ms": ms, "init_s": init_s, "peaks": peaks,
                         "ratios": ratios, "tokens": every[0],
                         "shares": {k: (clock.calls[k], v, v / ms[-1])
                                    for k, v in clock.ms.items()}}
            del step, args
            gc.collect()
            torch.cuda.empty_cache()
            if dist.get_rank() == 0 and device_type == "cuda":
                report = {"flash_attention": {}, "decode_attention": {}}
                name = recorded[kind]
                if kind == "prefill":
                    check_flash_rows("cards", calls[0][0],
                                     cfg.sliding_window, f"{arch} layer-0 "
                                     "prefill, rank 0 shard", report, gpu)
                else:
                    check_decode_at("cards", calls[0][0], f"{arch} layer-0 "
                                    "decode_32k, rank 0 shard", report, gpu)
                res["checks"][name] = {k: report[name][f"cards_{k}"]
                                       for k in ("ms", "plain_ms",
                                                 "max_abs_err")}
            del calls, rec
            gc.collect()
            dist.barrier()
    return results


def run_dryrun_cards(gpu, device_type="cuda"):
    """Phase 22 (b), with at least four cards, one process a card: each of
    DRYRUN_CARDS_ARCHS on DRYRUN_CARDS_MESH, first dry-run (each step in
    a process of its own, all at once; a train_4k step must not fit),
    then the steps that fit run by ``dryrun_cards_worker``. Returns their
    launches."""
    import gc
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from repro_torch.launch.mesh import hbm_bytes, run_on_mesh

    cards = torch.cuda.device_count() if device_type == "cuda" else 4
    if cards < 4:
        print(f"phase 22 (b): not run: it needs 4 cards and this machine "
              f"has {cards} (torch.cuda.device_count()); the prefill and "
              f"decode steps of {', '.join(DRYRUN_CARDS_ARCHS)} at full "
              f"width on 1x4 run on four cards")
        return {}
    t0 = time.perf_counter()
    shapes = steps_shapes()
    sizes = f"{DRYRUN_CARDS_MESH[0]}x{DRYRUN_CARDS_MESH[1]}"
    jobs = [(a, k) for a in DRYRUN_CARDS_ARCHS for k in DRYRUN_KINDS]
    with ProcessPoolExecutor(len(jobs), multiprocessing.get_context(
            "spawn"), initializer=_hide_cards) as pool:
        futures = {job: pool.submit(_dryrun_kind, *job, DRYRUN_CARDS_MESH)
                   for job in jobs}
        est = {a: {k: futures[a, k].result() for k in DRYRUN_KINDS}
               for a in DRYRUN_CARDS_ARCHS}
    dry_s = time.perf_counter() - t0
    for arch in DRYRUN_CARDS_ARCHS:
        for kind, e in est[arch].items():
            e["fits"] = e["memory"]["peak_bytes_per_device"] <= hbm_bytes()
            print(f"phase 22 (b) {arch} {shapes[kind].name} at batch 1 on "
                  f"{sizes}, dry run: {dryrun_line(e)}"
                  + ("" if e["fits"] or kind == "train" else
                     "; not run: the dry run says it does not fit")
                  + f" [{gpu}]")
        if est[arch]["train"]["fits"]:
            raise SystemExit(f"phase 22 (b) {arch}: the dry run says its "
                             f"train_4k step fits a card at {sizes}")
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    # the ranks draw each leaf whole and keep their block: expandable
    # segments keep those freed draws from fragmenting a card that the
    # rank's own params nearly fill
    with mock.patch.dict(os.environ, {
            "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}):
        res = run_on_mesh(*DRYRUN_CARDS_MESH, dryrun_cards_worker,
                          device_type, est, device=device_type,
                          timeout_s=900)
    launches = {}
    for arch, r_arch in res.items():
        for kind in ("prefill", "decode"):
            if kind not in r_arch:
                continue
            r = r_arch[kind]
            e = est[arch][kind]
            print(f"phase 22 (b) {arch} {shapes[kind].name} (S "
                  f"{shapes[kind].seq_len}, batch 1) on {sizes}: measured "
                  f"peak a rank {[round(x / 1e9, 3) for x in r['peaks']]} GB,"
                  f" {[round(x, 3) for x in r['ratios']]}x the estimate "
                  f"{e['memory']['peak_bytes_per_device'] / 1e9:.3f} GB; "
                  f"next tokens {r['tokens']} on every rank; args made in "
                  f"{r['init_s']:.1f} s; ms a call "
                  f"{[round(x, 1) for x in r['ms']]}, the last with each "
                  f"collective synchronised, model FLOPs over (s x peak) "
                  f"{model_flops_share(e, r['ms'][-1]):.4f}; collectives "
                  f"in it: "
                  + (", ".join(f"{k} {n} calls {ms:.1f} ms ({sh:.1%})"
                               for k, (n, ms, sh) in r["shares"].items())
                     or "none")
                  + f" (host clock) [{gpu}]")
        print(f"phase 22 (b) {arch}: kernels at rank 0's layer-0 inputs "
              f"{r_arch['checks']} [{gpu}]")
        add_launches(launches, r_arch["launches"])
    print(f"time phase 22 (b): {time.perf_counter() - t0:.1f} s (dry runs "
          f"{dry_s:.1f} s, the cards {time.perf_counter() - t1:.1f} s with "
          f"their processes' start); launches {launches} [{gpu}]")
    return launches


def dryrun_only(dev, gpu) -> int:
    """``--dryrun-only``: phase 22 alone, (a) and then (b) where there are
    four cards. Prints its checks and times, and no result line."""
    report = {"flash_attention": {}, "decode_attention": {}}
    launches = run_dryrun_1x1(dev, gpu, report)
    add_launches(launches, run_dryrun_cards(gpu))
    print(f"phase 22 alone: launches {launches} [{gpu}]")
    return 0


def steps_mesh_only(dev, gpu) -> int:
    """``--steps-mesh-only``: phase 21 alone, (a) and then (b) where there
    are four cards. Prints its checks and times, and no result line."""
    report = {"flash_attention": {}, "decode_attention": {}}
    launches = run_steps_1x1(dev, gpu, report)
    add_launches(launches, run_steps_cards(gpu))
    print(f"phase 21 alone: launches {launches} [{gpu}]")
    return 0


def mesh_only(dev, gpu) -> int:
    """``--mesh-only``: phase 20 alone, (a) over its own full-width itfi
    ranker and feature plane, then (b) where there are four cards. Prints
    its checks and times, and no result line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config("itfi-ranker")
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         torch.bfloat16, dev)
    plat, _ = build_platform(dev, params, cfg)
    now = 30 * DAY + 7200 + 60
    launches = run_mesh_1x1(dev, gpu, plat, params, now)
    del plat, params
    for k, v in run_mesh_cards(gpu).items():
        launches[k] = launches.get(k, 0) + v
    print(f"phase 20 alone: launches {launches} [{gpu}]")
    return 0


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
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
    if argv == ["--mesh-only"]:
        return mesh_only(dev, gpu)
    if argv == ["--steps-mesh-only"]:
        return steps_mesh_only(dev, gpu)
    if argv == ["--dryrun-only"]:
        return dryrun_only(dev, gpu)
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    report = {}
    check_history_merge(dev, report, gpu)
    check_flash_attention(dev, report, gpu)
    launches, plat, params, now = run_main_path(dev, gpu, report)
    check_decode_attention(dev, report)
    token_launches = run_token_path(dev, gpu, plat, params, now, report)
    run_slate_graph(dev, gpu, plat, params, now)
    gateway_launches = run_gateway_path(dev, gpu, plat, params, now)
    mesh_launches = run_mesh_1x1(dev, gpu, plat, params, now)
    check_ssd_scan(dev, report)
    ssm_launches = run_mamba2_path(dev, gpu, plat, now, report)
    ssm_gateway_launches = run_mamba2_gateway(dev, gpu, plat, now)
    run_sampled_decode(dev, gpu, plat, params, now)
    run_online_trainer(dev, gpu, plat, params, now)
    del plat, params
    ab_launches = run_ab_experiment(dev, gpu, report)
    scenario_launches = run_scenarios(dev, gpu)
    frontend_launches = run_frontend_archs(dev, gpu, report)
    steps_launches = run_steps_1x1(dev, gpu, report)
    dryrun_launches = run_dryrun_1x1(dev, gpu, report)
    cards_launches = run_mesh_cards(gpu)
    steps_cards_launches = run_steps_cards(gpu)
    dryrun_cards_launches = run_dryrun_cards(gpu)
    missing = set(names) ^ set(report)
    if missing:
        raise SystemExit(f"kernels without a check: {sorted(missing)}")
    for name, n in (*token_launches.items(), *gateway_launches.items(),
                    *ssm_launches.items(), *ssm_gateway_launches.items(),
                    *ab_launches.items(), *scenario_launches.items(),
                    *frontend_launches.items(), *mesh_launches.items(),
                    *steps_launches.items(), *cards_launches.items(),
                    *steps_cards_launches.items(),
                    *dryrun_launches.items(),
                    *dryrun_cards_launches.items()):
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
