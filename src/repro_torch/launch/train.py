"""Training launcher: the JAX package's ``launch/train.py`` on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --reduced --steps 50 --batch 8 --seq 128 [--ckpt out.msgpack] \
      [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given; ``--reduced``
is the 2-layer variant of the same family in f32, otherwise the full
config trains in bf16 with remat. The train step donates the params and
the optimizer state (``make_train_step(..., donate=True)``). Data: the
JAX launcher's synthetic next-token stream, drawn from
``np.random.RandomState(seed)`` as it draws it. ``--ckpt`` writes
``{"params": ...}`` with the step count and ``{"arch": name}`` through the
port's codec, a file the JAX package's ``load_checkpoint`` reads.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer CPU-scale variant of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; never falls back")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.common import resolve_device
    from repro_torch.models.model import init_params
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import TrainConfig, train

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family} device={device}")

    dtype = torch.float32 if args.reduced else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, dtype, device)
    opt = init_opt_state(params)
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps),
        microbatches=args.microbatches, remat=not args.reduced,
        param_dtype=dtype)

    rng = np.random.RandomState(args.seed)

    def gen_batches():
        # zipf-ish synthetic next-token stream with local structure
        for _ in range(args.steps):
            toks = rng.randint(1, cfg.vocab_size, (args.batch, args.seq))
            labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
            yield {"tokens": toks.astype(np.int32),
                   "labels": labels.astype(np.int32)}

    out = train(cfg, tcfg, params, opt, gen_batches(), log_every=10,
                donate=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": out["params"]},
                        step=args.steps, metadata={"arch": cfg.name})
        print(f"saved {args.ckpt}")


if __name__ == "__main__":
    main()
