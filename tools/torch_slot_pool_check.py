"""Slot-pool zero-collective check for the PyTorch port: the counterpart of
``tools/slot_pool_check.py``.

The JAX tool compiles the pool's one-hot gather and scatter on an 8x1
("data", "model") mesh and scans their HLO for collectives. The port has
no HLO: its pool (``serving/pool.py``) copies rows of slot buffers that
every data rank holds whole, and its collectives are the calls of
``sharding/local.py``, each of which reports itself to an active
``launch/op_analysis.py`` analysis. This tool serves pooled Gateway
arrivals (admit -> scatter -> gather -> inject -> decode) on an 8x1 gloo
mesh, one spawned process a rank, runs each of the pool's gathers and
scatters under ``op_analysis.analyze`` and asserts that none records a
collective. The prefill pane's all-gather over ``data``
(``engine.full_pane``, which the Gateway runs before each scatter, as
the JAX Gateway reshards the pane before its scatter program) is recorded
the same way and must show one all-gather a leaf, so the recorder is seen
to be live.

  PYTHONPATH=src python tools/torch_slot_pool_check.py

Prints ``SLOT-POOL OK collectives=0`` and exits 0 on success.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

DAY = 86400
N_USERS, N_ITEMS = 40, 300
DATA = 8


def _recorded(obj, name, log):
    """Replace ``obj.name`` by a wrapper that runs it under
    ``op_analysis.analyze`` and appends its collective records to
    ``log``."""
    from repro_torch.launch.op_analysis import analyze
    real = getattr(obj, name)

    def wrapper(*args):
        out, cost = analyze(real, args)
        log.append([list(c) for c in cost.collectives])
        return out
    setattr(obj, name, wrapper)


def check_rank(mesh):
    """On one rank: the tool's tiny model (fp32, seed 0) behind a pooled
    Gateway on ``mesh``, four continuous arrivals served. Returns the
    collective records of each pool gather and scatter and each pane
    all-gather, and the pool's counters."""
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.feature_store import (BatchFeatureStore,
                                                FeatureStoreConfig)
    from repro_torch.core.injection import FeatureInjector, InjectionConfig
    from repro_torch.core.realtime import (RealtimeConfig,
                                           RealtimeFeatureService)
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import ServingConfig, ServingEngine
    from repro_torch.serving.scheduler import Gateway, ServerConfig

    cfg = ModelConfig(name="pool-check", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=N_ITEMS + 256, rope_theta=1e4,
                      tie_embeddings=True)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu", mesh=mesh)
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=8, prefill_len=32, inject_len=8, cache_capacity=64),
        device="cpu", mesh=mesh)
    store = BatchFeatureStore(FeatureStoreConfig(n_users=N_USERS,
                                                 feature_len=24))
    rts = RealtimeFeatureService(RealtimeConfig(
        n_users=N_USERS, buffer_len=8, ingest_latency=0))
    rng = np.random.RandomState(0)
    u = rng.randint(0, N_USERS, 1500)
    it = rng.randint(0, N_ITEMS, 1500)
    ts = rng.randint(0, 5 * DAY, 1500)
    store.extend(u, it, ts)
    rts.extend(u, it, ts)
    inj = FeatureInjector(InjectionConfig(policy="inject", feature_len=24),
                          store, rts, device="cpu")
    gw = Gateway(eng, inj, ServerConfig(slate_len=3, pool_slots=16,
                                        max_wait=0))
    pool = gw.pool
    logs = {"gather": [], "scatter": [], "full_pane": []}
    _recorded(pool, "gather", logs["gather"])
    _recorded(pool, "scatter", logs["scatter"])
    _recorded(eng, "full_pane", logs["full_pane"])

    now = 5 * DAY + 100
    for j, user in enumerate([3, 7, 3, 11]):
        t = gw.submit(Request(user=user, now=now + j))
        assert t.done, t
    done = gw.poll()
    assert len(done) == 4 and gw.cache.hits >= 1, gw.cache.stats()
    return {**logs, "gathers": pool.gathers, "scatters": pool.scatters}


def main() -> int:
    from repro_torch.launch.mesh import run_on_mesh

    res = run_on_mesh(DATA, 1, check_rank, device="cpu", timeout_s=240)
    assert (res["gathers"], res["scatters"]) == (4, 3), res
    assert len(res["gather"]) == 4 and len(res["scatter"]) == 3, res
    ng = sum(len(r) for r in res["gather"])
    ns = sum(len(r) for r in res["scatter"])
    # the pane all-gathers before each scatter: one a state leaf, over
    # the data axis's eight ranks
    panes = res["full_pane"]
    assert len(panes) >= 3 and all(r and all(
        c[0] == "all-gather" and c[2] == DATA for c in r) for r in panes), \
        panes
    print(f"gather: collectives={ng}  scatter: collectives={ns} "
          f"({DATA}-way data mesh, 16 slots; the pane all-gathers before "
          f"the scatters recorded {sum(len(r) for r in panes)} "
          f"collectives)")
    assert ng == 0, f"slot gather recorded {ng} collectives"
    assert ns == 0, f"slot scatter recorded {ns} collectives"
    print(f"SLOT-POOL OK collectives={ng + ns}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
