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

``--loop`` instead drives the request-level Gateway (feature stores ->
injector -> host prefill-state LRU or device state pool -> engine behind
the micro-batching scheduler) with a deterministic seeded request trace:
arrivals trickle in one at a time (``gateway.submit``), feedback events
ride along between them (``gateway.observe``), panes flush on pane-full
or deadline, and served results are claimed off the streaming surface
(``gateway.drain``). With ``--ab`` each arrival carries its user's
hash-assigned A/B arm (``core.ab.request_arm``, salted with ``--seed``)
as its serving policy and tag, so control and treatment rows share the
same panes; the last round prints its per-arm split. It prints per-round
throughput and the gateway's telemetry summary:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch itfi-ranker \
      --reduced --device cpu --loop --users 200 --rounds 4 \
      [--ab] [--roll-midway] [--build-budget N] [--rewarm N] \
      [--max-wait SECS]

``--pool SLOTS`` swaps the host LRU for the paged device-resident state
pool (slot-table cache, indexed gather/scatter pane assembly on the
engine's device):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch itfi-ranker \
      --reduced --device cpu --loop --pool 64 --max-wait 0

``--scenario NAME`` replays one named production traffic scenario
(``serving/loadgen.py``: diurnal, flash_crowd, cold_start_storm,
churn_heavy, mixed_fleet) through the Gateway on ``--device`` and prints
its SLO scorecard; ``--smoke`` shrinks the trace. mixed_fleet keeps its
own roster of reduced archs; every other scenario runs on the harness's
tiny ranker, or on a reduced variant of ``--arch`` when given:

  PYTHONPATH=src python -m repro_torch.launch.serve --scenario diurnal \
      --smoke --device cpu

``--mesh DATA,MODEL`` runs either mode sharded over a ("data", "model")
device mesh: ``DATA * MODEL`` processes (``launch/mesh.py``,
``run_on_mesh``), gloo ranks with ``--device cpu`` and one NCCL rank a
card with ``--device cuda``. Every rank runs the same program; rank 0
prints. ``--batch`` must be a multiple of ``DATA``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch itfi-ranker \
      --reduced --device cpu --loop --mesh 2,1 --batch 4 --users 40
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

DAY = 86400


def run_loop(cfg, params, args, device, mesh=None, log=print) -> None:
    """Deterministic seeded request trace through the Gateway:
    per-request arrivals interleaved with feedback events, pane-full and
    deadline flushes, optional per-request A/B arms, and optionally a
    generation rollover midway."""
    from repro_torch.core.ab import ARM_POLICIES, request_arm
    from repro_torch.core import (BatchFeatureStore, FeatureInjector,
                                  FeatureStoreConfig, InjectionConfig,
                                  RealtimeConfig, RealtimeFeatureService)
    from repro_torch.serving import Gateway, Request, ServerConfig

    n_users, n_items = args.users, cfg.vocab_size - 256
    feature_len = min(args.history, 64)
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=args.batch, prefill_len=args.history,
        inject_len=args.fresh,
        cache_capacity=args.history + args.fresh + 64), device=device,
        mesh=mesh)
    rng = np.random.RandomState(args.seed)

    store = BatchFeatureStore(FeatureStoreConfig(
        n_users=n_users, feature_len=feature_len))
    rts = RealtimeFeatureService(RealtimeConfig(
        n_users=n_users, buffer_len=16, ingest_latency=0))
    n_ev = n_users * 16
    us = rng.randint(0, n_users, n_ev)
    its = rng.randint(0, n_items, n_ev)
    tss = rng.randint(0, 5 * DAY, n_ev)
    store.extend(us, its, tss)
    rts.extend(us, its, tss)
    inj = FeatureInjector(InjectionConfig(
        policy=args.policy, feature_len=feature_len), store, rts,
        device=device)
    gw = Gateway(eng, inj, ServerConfig(
        slate_len=4, cache_entries=n_users,
        pool_slots=args.pool, max_wait=args.max_wait,
        snapshot_build_budget=args.build_budget,
        rewarm_budget=args.rewarm))
    if args.pool:
        log(f"paged state pool: {args.pool} device slots x "
              f"{gw.pool.slot_nbytes / 1e6:.2f} MB/slot"
              + (f", continuous max_wait={args.max_wait}s"
                 if args.max_wait is not None else ""))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    now = 5 * DAY + 100
    t0 = time.perf_counter()
    warmed = gw.warm(np.arange(n_users), now)
    sync()
    log(f"warm: {warmed} prefill states in "
          f"{time.perf_counter() - t0:.2f} s")

    deadline = args.batch * 2  # seconds an arrival may wait in the queue
    per_round = args.batch * 4
    for r in range(args.rounds):
        tickets = []
        t0 = time.perf_counter()
        for _ in range(per_round):
            # the trace interleaves arrivals with feedback events
            # (~1 event per 4 requests), all from one seeded stream
            if rng.rand() < 0.25:
                gw.observe((int(rng.randint(0, n_users)),
                            int(rng.randint(0, n_items)), now - 30))
            u = int(rng.randint(0, n_users))
            if args.ab:
                arm = request_arm(u, salt=args.seed)
                req = Request(user=u, now=now, policy=ARM_POLICIES[arm],
                              tag=arm, deadline=now + deadline)
            else:
                req = Request(user=u, now=now, deadline=now + deadline)
            tickets.append(gw.submit(req))
            now += 1  # one arrival per second
        served = gw.drain(now + deadline)  # tail deadline fires + claim
        sync()
        dt = time.perf_counter() - t0
        if not all(t.done for t in tickets) or not \
                {t.request_id for t in served} >= {t.request_id
                                                  for t in tickets}:
            raise SystemExit(f"round {r}: a request was not served")
        hits = sum(t.response.telemetry.cache_hit for t in tickets)
        qd = np.array([t.response.telemetry.queue_delay for t in tickets])
        log(f"round {r}: {len(tickets)} reqs in {dt * 1e3:6.1f} ms "
              f"({len(tickets) / dt:7.1f} req/s) hits={hits} "
              f"queue-delay p50={np.percentile(qd, 50):.0f}s "
              f"max={qd.max()}s slate[0]="
              f"{tickets[0].response.slate.tolist()}")
        # the next round's arrivals must not be stamped behind the clock
        # the tail flush advanced to (now + deadline)
        now += max(60, deadline)
        if args.roll_midway and r == args.rounds // 2 - 1:
            # jump the clock past the next daily boundary so the second
            # half of the trace serves across a generation rollover
            now = ((now // DAY) + 1) * DAY + 100
            gw.tick(now)
            ro = gw.stats().rollover
            log(f"-- generation rollover at {now}: rekeyed={ro.rekeyed} "
                  f"invalidated={ro.invalidated} "
                  f"pending_build={ro.pending_build_users} "
                  f"pending_rewarm={ro.pending_rewarm}")

    st = gw.stats()
    if args.ab:
        by_arm = {}
        for t in tickets:
            by_arm.setdefault(t.response.telemetry.tag, 0)
            by_arm[t.response.telemetry.tag] += 1
        log(f"last-round arms (mixed panes): {by_arm}")
    log(f"telemetry: paths={st.paths} "
          f"queue_delay p50={st.queue_delay['p50']:.0f}s "
          f"p99={st.queue_delay['p99']:.0f}s "
          f"deadline_flushes={st.deadline_flushes} panes={st.panes}")
    ro = st.rollover
    log(f"rollover: rollovers={ro.rollovers} rekeyed={ro.rekeyed} "
          f"invalidated={ro.invalidated} rebuilt={ro.rebuilt} "
          f"build_steps={ro.build_steps} "
          f"build_time={ro.build_time_s * 1e3:.1f}ms")
    log(f"stats: {st.as_dict()}")


def run_scenario_cli(args, device) -> None:
    """--scenario NAME: replay one named traffic scenario against the
    chosen arch and print the SLO scorecard (the JAX launcher's lines)."""
    import dataclasses

    from repro_torch.serving.loadgen import get_scenario, run_scenario

    spec = get_scenario(args.scenario, smoke=args.smoke)
    if args.arch and not spec.archs:
        spec = dataclasses.replace(spec, archs=(args.arch,))
    print(f"scenario {spec.name}: horizon={spec.horizon}s "
          f"users={spec.n_users} shed_policy={spec.shed_policy}")
    for res in run_scenario(spec, device=device):
        m = res.metrics
        print(f"\n[{res.arch}] trace={res.trace_fingerprint} "
              f"slates={res.slate_fingerprint}")
        print(f"  requests={m['requests']} served={m['served']} "
              f"shed={m['shed']} deadline_misses={m['deadline_misses']} "
              f"hit_rate={m['hit_rate']:.2f}")
        print(f"  queue delay p50/p99/max = {m['queue_delay']['p50']:.0f}/"
              f"{m['queue_delay']['p99']:.0f}/{m['queue_delay']['max']}s")
        for g in res.gates:
            mark = "PASS" if g["pass"] else "FAIL"
            print(f"  [{mark}] {g['gate']:22s} budget={g['budget']} "
                  f"actual={g['actual']}")
        print(f"  SLO: {'PASS' if res.slo_pass else 'FAIL'}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None,
                    help="registered model config (required unless "
                         "--scenario, which defaults to its own tiny "
                         "ranker / fleet roster)")
    ap.add_argument("--reduced", action="store_true",
                    help="a 2-layer, 256-wide variant of --arch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--history", type=int, default=256,
                    help="padded batch-history length (prefill)")
    ap.add_argument("--fresh", type=int, default=8,
                    help="padded fresh-suffix length (inject)")
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loop", action="store_true",
                    help="drive the request-level Gateway with a seeded trace")
    ap.add_argument("--users", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--policy", default="inject",
                    choices=["batch", "inject", "fresh"])
    ap.add_argument("--roll-midway", action="store_true",
                    help="--loop: jump the clock past a daily boundary "
                         "halfway through the trace (warm handoff)")
    ap.add_argument("--build-budget", type=int, default=None,
                    help="--loop: at most this many users materialised per "
                         "clock call by the snapshot build")
    ap.add_argument("--rewarm", type=int, default=0,
                    help="--loop: re-prefill up to this many "
                         "rollover-invalidated users per tick")
    ap.add_argument("--max-wait", type=int, default=None, metavar="SECS",
                    help="--loop: continuous batching; flush a partial pane "
                         "once its oldest arrival has waited this long")
    ap.add_argument("--pool", type=int, default=None, metavar="SLOTS",
                    help="--loop: paged device-resident state pool with "
                         "this many slots (replaces the host LRU; must "
                         "be >= --batch)")
    ap.add_argument("--ab", action="store_true",
                    help="--loop: per-request A/B arms (control = batch, "
                         "treatment = inject) sharing the same panes")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="run sharded over a data,model mesh of processes "
                         "(e.g. 2,1); --batch must be a multiple of the "
                         "data size")
    ap.add_argument("--scenario", default=None, metavar="NAME",
                    help="replay a named production traffic scenario "
                         "(diurnal / flash_crowd / cold_start_storm / "
                         "churn_heavy / mixed_fleet) through the Gateway "
                         "against this --arch (reduced shapes) and print "
                         "the SLO scorecard; --smoke shrinks the trace")
    ap.add_argument("--smoke", action="store_true",
                    help="--scenario: short-horizon variant of the trace")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.scenario:
        run_scenario_cli(args, device)
        return
    if args.arch is None:
        ap.error("--arch is required (except with --scenario)")
    if args.mesh is None:
        serve(None, args)
        return
    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) != 2:
        raise SystemExit("--mesh wants two sizes: data,model")
    from repro_torch.launch import serve as this  # by name, for the ranks
    from repro_torch.launch.mesh import run_on_mesh
    run_on_mesh(*shape, this.serve, args, device=device)


def serve(mesh, args) -> None:
    """Either mode, on ``mesh`` (a rank of it; rank 0 prints) or on one
    device."""
    import torch.distributed as dist

    device = resolve_device(args.device)
    log = print
    if mesh is not None:
        if dist.get_rank() != 0:
            def log(*a, **k):
                return None
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        log(f"mesh: data={sizes['data']} model={sizes['model']} "
            f"({dist.get_world_size()} {dist.get_backend()} ranks)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         torch.float32, device, mesh=mesh)
    if args.loop:
        run_loop(cfg, params, args, device, mesh, log)
        return
    scfg = ServingConfig(max_batch=args.batch, prefill_len=args.history,
                         inject_len=args.fresh,
                         cache_capacity=args.history + args.fresh + 64)
    eng = ServingEngine(cfg, params, scfg, device=device, mesh=mesh)
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
        log(f"{name:22s} cold={t1 - t0:7.3f}s "
            f"warm={time.perf_counter() - t1:7.3f}s")
        return out

    if cfg.ssm is None:
        mixer = f"{cfg.n_heads} heads of {cfg.head_dim_}"
    else:
        mixer = (f"{cfg.n_ssm_heads} SSD heads of {cfg.ssm.head_dim}, "
                 f"d_state {cfg.ssm.d_state}")
    log(f"arch {cfg.name} on {device}: {cfg.n_layers} layers, d "
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
    last = eng.full_rows(tok)[:, 0].tolist()  # every rank joins the gather
    log(f"decode: {args.decode_steps} steps, {dt * 1e3:.1f} ms/step; "
        f"last tokens {last}")


if __name__ == "__main__":
    main()
