#!/usr/bin/env python3
"""The Gateway's copies between the card and its host prefill-state LRU,
through pinned memory against through pageable memory, on one GPU.

    python3 tools/gateway_host_copy.py

Runs ``chip_smoke.py``'s Gateway phase from the host prefill-state LRU
only (a warm pass of 1024 users, a hit wave from the LRU, a miss wave of
1024 other users, and its checks) on the full-width ``itfi-ranker`` over
``chip_smoke.py``'s feature plane four times in one process, in the
order pageable, pinned, pinned, pageable, so that the reuse of host
memory freed by an earlier run's LRU favours neither. ``pinned`` is ``serving/scheduler.py`` as it
is; ``pageable`` copies each leaf of a prefill state to the host with
``Tensor.cpu()`` (into fresh pageable memory) and assembles a pane with
``torch.cat`` and ``Tensor.to``. Each run prints the phase's lines: ms per
pane by phase ("host copy" is the device->host copy, "assembly" the host
concat and the host->device copy) and requests/s.
"""
from __future__ import annotations

import contextlib
import gc
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
ORDER = ("pageable", "pinned", "pinned", "pageable")


def pageable_host_state(state):
    """``_host_state`` with every leaf copied by ``Tensor.cpu()``."""
    from repro_torch.serving import scheduler
    return {
        "caches": scheduler._tree_map(lambda x: x.cpu(), state["caches"]),
        "valid": state["valid"].cpu(),
        "next_pos": state["next_pos"].cpu(),
        "last_logits": state["logits"][:, -1].cpu(),
    }


def pageable_join(xs, dim, device, stack=False):
    """``_join`` without pinned staging."""
    import torch
    return (torch.stack if stack else torch.cat)(xs, dim=dim).to(device)


def main() -> int:
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("gateway_host_copy: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import init_params
    from repro_torch.serving import scheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = cs.card()
    _build.build(_build.kernel_names())
    cfg = get_config("itfi-ranker")
    params = init_params(cfg, torch.Generator().manual_seed(cs.SEED),
                         torch.bfloat16, dev)
    plat, _ = cs.build_platform(dev, params, cfg)
    now = 30 * cs.DAY + 7200 + 60
    for i, variant in enumerate(ORDER):
        print(f"--- run {i}: {variant} host copies [{gpu}]")
        with contextlib.ExitStack() as stack:
            if variant == "pageable":
                stack.enter_context(mock.patch.object(
                    scheduler, "_host_state", pageable_host_state))
                stack.enter_context(mock.patch.object(
                    scheduler, "_join", pageable_join))
            cs.run_gateway_path(dev, gpu, plat, params, now,
                                backends=("host LRU",))
        gc.collect()
        torch.cuda.empty_cache()
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
