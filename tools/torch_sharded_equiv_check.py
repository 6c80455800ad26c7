"""Sharded-vs-one-device serving equivalence check for the PyTorch port.

The JAX package's ``tools/sharded_equiv_check.py`` trace, on the port: the
same tiny model and feature plane, once behind a Gateway on the mesh-free
engine and once on a ("data", "model") mesh of spawned processes, driven
through the same request trace (per-request submits, interleaved ingest)
with cached hits, a mixed-policy wave (batch/inject/fresh rows sharing
panes) and two snapshot-generation rollovers: one crossed by a request's
clock mid-trace, one rolled by ``tick()`` between waves, so the warm
handoff (rekeyed rows serve the next wave, changed rows re-prefill) runs
and its telemetry is compared across meshes. At every wave the slates
must be equal, the hit counts equal and the scores within 2e-3; the
rollover telemetry must be equal, and the sharded cache must count the
data size as its shards.

  PYTHONPATH=src python tools/torch_sharded_equiv_check.py [--mesh 8,1]
      [--device cpu|cuda] [--pool SLOTS]

On the CPU each rank is a gloo process; on CUDA an NCCL process a card
(``--mesh`` needs that many cards). Prints ``TORCH-SHARDED-EQUIV OK`` and
exits 0 on success.
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

DAY = 86400
N_USERS, N_ITEMS = 40, 300
SCORE_TOL = 2e-3


def model_config(pkg):
    """The tool's tiny model, as package ``pkg``'s ``ModelConfig``."""
    return pkg.ModelConfig(name="equiv-test", family="dense", n_layers=2,
                           d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                           vocab_size=N_ITEMS + 256, rope_theta=1e4,
                           tie_embeddings=True)


def build_gateway(engine, feature_store, realtime, injection, scheduler,
                  pool_slots=None, **injector_kw):
    """The tool's feature plane and Gateway around ``engine``, from
    either package's modules (the trace's events from RandomState(0))."""
    store = feature_store.BatchFeatureStore(feature_store.FeatureStoreConfig(
        n_users=N_USERS, feature_len=24))
    rts = realtime.RealtimeFeatureService(realtime.RealtimeConfig(
        n_users=N_USERS, buffer_len=8, ingest_latency=0))
    rng = np.random.RandomState(0)
    u = rng.randint(0, N_USERS, 1500)
    i = rng.randint(0, N_ITEMS, 1500)
    t = rng.randint(0, 5 * DAY, 1500)
    store.extend(u, i, t)
    rts.extend(u, i, t)
    inj = injection.FeatureInjector(injection.InjectionConfig(
        policy="inject", feature_len=24), store, rts, **injector_kw)
    budget = ({"pool_slots": pool_slots} if pool_slots
              else {"cache_entries": 64})
    return scheduler.Gateway(engine, inj, scheduler.ServerConfig(
        slate_len=3, **budget))


def counters(stats) -> dict:
    """The fields of a stats dataclass that take part in its equality
    (every field but the wall-clock ones), nested ones as dicts too."""
    def plain(v):
        return counters(v) if dataclasses.is_dataclass(v) else v
    return {f.name: plain(getattr(stats, f.name))
            for f in dataclasses.fields(stats) if f.compare}


def trace(gw, request_cls):
    """The JAX tool's five waves through ``gw``. Returns a record of each
    wave's slates, scores and hits, the rollover telemetry and rekeys
    after the explicit tick, and the cache's closing counters."""
    rng = np.random.RandomState(1)
    now = 5 * DAY + 100
    policies = [None, "batch", "inject", "fresh"]
    rec = {"waves": []}
    for wave, at in enumerate([now, now + 120, now + 300,
                               now + DAY + 100, now + 2 * DAY + 100]):
        if wave == 4:
            # events for a few users only, then roll the generation on the
            # clock before any request arrives
            u5 = np.arange(5)
            it5 = rng.randint(0, N_ITEMS, 5)
            gw.observe_many(u5, it5, np.full(5, at - 3600))
            gw.tick(at - 60)
            rec["rollover"] = counters(gw.stats()["rollover"])
            rec["rekeys"] = gw.cache.rekeys
        u = rng.randint(0, N_USERS, 12)
        it = rng.randint(0, N_ITEMS, 12)
        gw.observe_many(u, it, np.full(12, at - 40))
        q = rng.randint(0, N_USERS, 19)  # pane-splits at max_batch=8
        reqs = [request_cls(user=int(x), now=at,
                            policy=policies[j % 4] if wave == 2 else None)
                for j, x in enumerate(q)]
        tickets = [gw.submit(r) for r in reqs]  # trickle: pane-full
        gw.flush(at)                            # flushes + tail
        rec["waves"].append({
            "slates": np.stack([t.response.slate for t in tickets]),
            "scores": np.stack([t.response.scores for t in tickets]),
            "hits": sum(bool(t.response.telemetry.cache_hit)
                        for t in tickets)})
    rec["cache"] = {"hits": gw.cache.hits, "misses": gw.cache.misses,
                    "invalidations": gw.cache.invalidations,
                    "shards": gw.cache.shards}
    rec["paths"] = dict(gw.stats()["paths"])
    rec["stats"] = counters(gw.stats())
    return rec


def port_record(mesh, params_np=None, pool_slots=None, device="cpu"):
    """The trace on the port's Gateway: on ``mesh`` (None: the mesh-free
    engine; else on this rank, through ``run_on_mesh``), with weights
    from ``params_np`` (the JAX tree as numpy) or drawn in fp32 from
    seed 0."""
    import torch

    import repro_torch.configs.base as base
    from repro_torch.core import feature_store, injection, realtime
    from repro_torch.models.model import init_params
    from repro_torch.serving import scheduler
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import ServingConfig, ServingEngine
    from repro_torch.weights import params_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config(base)
    if params_np is None:
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, device, mesh=mesh)
    else:
        params = params_from_numpy(params_np, cfg, device, mesh=mesh)
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=8, prefill_len=32, inject_len=8, cache_capacity=64),
        device=device, mesh=mesh)
    gw = build_gateway(eng, feature_store, realtime, injection, scheduler,
                       pool_slots, device=device)
    return trace(gw, Request)


def compare(want, got, label="sharded", score_tol=SCORE_TOL,
            data_shards=None, pooled=False) -> None:
    """Assert the JAX tool's checks between two records; prints a line a
    wave."""
    for w, (a, b) in enumerate(zip(want["waves"], got["waves"])):
        assert (a["slates"] == b["slates"]).all(), \
            f"wave {w}: slates diverged\n{a['slates']}\n{b['slates']}"
        assert a["hits"] == b["hits"], \
            f"wave {w}: hit counts diverged {a['hits']} != {b['hits']}"
        diff = float(np.abs(a["scores"] - b["scores"]).max())
        assert diff < score_tol, f"wave {w}: scores max|d|={diff}"
        print(f"wave {w}: slates equal, scores max|d|={diff:.2e}, "
              f"hits={b['hits']} ({label})")
    assert want["rollover"] == got["rollover"], \
        f"rollover stats diverged\n{want['rollover']}\n{got['rollover']}"
    r = got["rollover"]
    assert r["rekeyed"] > 0 and r["retained"] > 0, r
    assert want["rekeys"] == got["rekeys"] > 0
    print(f"mid-trace rollover: rekeyed={r['rekeyed']} "
          f"retained={r['retained']} (both)")
    for k in ("hits", "misses", "invalidations"):
        assert want["cache"][k] == got["cache"][k], (k, want["cache"],
                                                     got["cache"])
    # every counter equal but the shards and the per-shard bytes, which
    # divide one device's bytes by the data shards (the host LRU's panes
    # shard over data; the pool's slots are replicated)
    w, g = dict(want["stats"]), dict(got["stats"])
    wc, gc = dict(w.pop("cache")), dict(g.pop("cache"))
    assert w == g, (w, g)
    wb, gb = wc.pop("bytes_per_shard"), gc.pop("bytes_per_shard")
    wc.pop("shards"), gc.pop("shards")
    assert wc == gc, (wc, gc)
    n = wc["entries"]
    shards = 1 if pooled or data_shards is None else data_shards
    assert gb == n * -(-(wb // max(n, 1)) // shards), (wb, gb, n, shards)
    assert got["cache"]["hits"] > 0 and got["paths"]["inject"] > 0
    if not pooled:  # the pool renames slots where the LRU invalidates
        assert got["cache"]["invalidations"] > 0, got["cache"]
    if data_shards is not None:
        assert got["cache"]["shards"] == data_shards, got["cache"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="8,1", metavar="DATA,MODEL")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--pool", type=int, default=None, metavar="SLOTS",
                    help="serve from the device state pool (>= 8 slots) "
                         "instead of the host LRU")
    args = ap.parse_args(argv)
    data, model = (int(x) for x in args.mesh.split(","))

    from repro_torch.launch.mesh import run_on_mesh

    t0 = time.perf_counter()
    single = port_record(None, pool_slots=args.pool, device=args.device)
    sharded = run_on_mesh(data, model, port_record, None, args.pool,
                          args.device, device=args.device)
    compare(single, sharded, f"mesh {data}x{model}", data_shards=data,
            pooled=args.pool is not None)
    print(f"mesh {data}x{model} on {args.device}: "
          f"{time.perf_counter() - t0:.1f} s")
    print("TORCH-SHARDED-EQUIV OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
