"""Serving launcher — the paper's injection on the token-level engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch itfi-ranker \
      [--reduced] [--device cuda|cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --reduced

Runs the three-phase request path on seeded random histories:
  1. prefill(batch history)   — the daily-job-cacheable state
  2. inject(fresh events)     — the paper's inference-time injection
  3. finalize + decode steps  — unchanged serving
and prints each phase's time, cold (first call) and warm, showing that
injection costs O(suffix) rather than O(history). Times end in a device
synchronise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.models.common import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serving.engine import ServingConfig, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="a 2-layer, 256-wide variant of --arch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--history", type=int, default=256,
                    help="padded batch-history length (prefill)")
    ap.add_argument("--fresh", type=int, default=16,
                    help="padded fresh-suffix length (inject)")
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         torch.float32, device)
    scfg = ServingConfig(max_batch=args.batch, prefill_len=args.history,
                         inject_len=args.fresh,
                         cache_capacity=args.history + args.fresh + 64)
    eng = ServingEngine(cfg, params, scfg, device=device)
    rng = np.random.RandomState(args.seed)
    hists = [list(rng.randint(1, cfg.vocab_size, rng.randint(
        args.history // 2, args.history))) for _ in range(args.batch)]
    fresh = [list(rng.randint(1, cfg.vocab_size, rng.randint(1, args.fresh)))
             for _ in range(args.batch)]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        sync()
        t1 = time.perf_counter()
        out = fn(*a)
        sync()
        print(f"{name:22s} cold={t1 - t0:7.3f}s "
              f"warm={time.perf_counter() - t1:7.3f}s")
        return out

    if cfg.ssm is None:
        mixer = f"{cfg.n_heads} heads of {cfg.head_dim_}"
    else:
        mixer = (f"{cfg.n_ssm_heads} SSD heads of {cfg.ssm.head_dim}, "
                 f"d_state {cfg.ssm.d_state}")
    print(f"arch {cfg.name} on {device}: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {mixer}, vocab {cfg.vocab_size}, float32 weights "
          f"from seed {args.seed}")
    toks, valid = eng.pad_tokens(hists, args.history)
    state = timed("prefill(batch hist)", eng.prefill, toks, valid)
    stoks, svalid = eng.pad_tokens(fresh, args.fresh, align="left")
    state = timed("inject(fresh events)", eng.inject, state, stoks, svalid)
    dec = timed("finalize(ring cache)", eng.finalize, state)

    tok = torch.ones((args.batch, 1), dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    for _ in range(args.decode_steps):
        logits, dec = eng.decode(dec, tok)
        tok = eng.sample(logits)[:, None]
    sync()
    dt = (time.perf_counter() - t0) / max(args.decode_steps, 1)
    if not torch.isfinite(logits[:, :cfg.vocab_size]).all():
        raise SystemExit("non-finite decode logits")
    print(f"decode: {args.decode_steps} steps, {dt * 1e3:.1f} ms/step; "
          f"last tokens {tok[:, 0].tolist()}")


if __name__ == "__main__":
    main()
