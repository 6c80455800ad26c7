"""A/B experiment harness — reproduces the paper's §IV result structure
(the JAX package's ``core/ab.py`` on the port's platform and trainer).

Phases:

  0. **bootstrap** — a popularity policy serves for ``bootstrap_days``,
     producing generation-0 logs (no model yet).
  1. **generation 1** — a ranker trained on gen-0 logs (batch cutoff) is
     deployed with *batch* features for ``gen1_days``. Its logs carry the
     feedback loop: watches are drawn from this model's slates.
  2. **generation 2** — two rankers are trained on the full log:
       * M_batch  — midnight cutoff (the paper's untouched batch model),
       * M_cons   — fresh cutoff with the explicit recent-segment features
         (the paper's "consistent" variant).
  3. **the experiment** — paired arms over ``ab_days`` with common random
     numbers (identical session schedules, intent drift and choice noise;
     only the slates differ):
       * control    — M_batch + batch features (24 h refresh)
       * treatment  — M_batch + inference-time injection   ← the paper
       * consistent — M_cons  + train/serve-consistent fresh features
     plus optional latency-ablation arms (feature staleness λ).

Reproduction targets (§IV): treatment lift significant & positive;
consistent ≈ control (no measurable gain). Magnitudes are sim-specific.

The rankers train and serve on ``device`` (``"cuda"`` by default; pass
``"cpu"`` to run there). The simulator, the feature plane, the training
data and the statistics are host-side numpy, bit for bit the JAX
package's.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.feature_store import BatchFeatureStore, FeatureStoreConfig
from repro_torch.core.injection import FeatureInjector, InjectionConfig
from repro_torch.core.metrics import (paired_user_test, summarize_arm,
                                      two_proportion_z)
from repro_torch.core.pipeline import PipelineConfig, RecommenderPlatform
from repro_torch.core.realtime import RealtimeConfig, RealtimeFeatureService
from repro_torch.data.loader import LoaderConfig, batches, build_examples
from repro_torch.data.synthetic import (World, WorldConfig, bootstrap_serve_fn,
                                        events_to_arrays, simulate_day)
from repro_torch.models import model as model_mod
from repro_torch.models.common import resolve_device
from repro_torch.serving.api import Request, hash_arm
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_loop import TrainConfig, train

DAY = 86400

# The paper's §IV arms that share one set of model parameters (M_batch)
# and differ only in the serving-time feature policy — exactly the pair
# a request-level deployment serves from ONE fleet via per-request
# policies (mixed-policy panes) instead of one server per arm.
ARM_POLICIES = {"control": "batch", "treatment": "inject"}

# Extended experiment including the model-free recency baseline (policy
# "decay", Interest Clock arXiv 2404.19357). A separate mapping — NOT a
# mutation of ARM_POLICIES — because hash_arm buckets users by the arm
# tuple: the default two-arm assignment must stay stable.
DECAY_ARM_POLICIES = {"control": "batch", "treatment": "inject",
                      "decay": "decay"}


def request_arm(user: int, salt: int = 0,
                arms: Optional[Dict[str, str]] = None) -> str:
    """Deterministic per-request arm assignment (user-randomized, as in
    the paper; stable across processes via :func:`hash_arm`). ``arms``
    selects an alternative arm->policy mapping (e.g.
    :data:`DECAY_ARM_POLICIES`); different mappings are different
    experiments and bucket users independently."""
    return hash_arm(int(user), tuple(arms or ARM_POLICIES), salt)


def arm_requests(users, now: int, salt: int = 0,
                 arms: Optional[Dict[str, str]] = None) -> List[Request]:
    """Label a wave of arrivals with their experiment arm: each request
    carries its arm's serving policy and the arm name as ``tag``, ready
    for ``Gateway.submit_many`` — control and treatment rows then
    coexist in the same fixed-shape panes, and the per-arm split is
    recovered from ``response.telemetry.tag``."""
    arms = arms or ARM_POLICIES
    out = []
    for u in np.asarray(users).ravel():
        arm = request_arm(int(u), salt, arms)
        out.append(Request(user=int(u), now=int(now),
                           policy=arms[arm], tag=arm))
    return out


def default_sim_model(n_items: int) -> ModelConfig:
    """CPU-budget ranker for the simulation (the registered ``itfi-ranker``
    config is the production-shaped version)."""
    return ModelConfig(
        name="itfi-ranker-sim", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=n_items + 256,
        rope_theta=10000.0, tie_embeddings=True,
        source="paper §III ranking model, simulation-scale")


@dataclasses.dataclass(frozen=True)
class ABConfig:
    world: WorldConfig = WorldConfig(n_users=800, n_items=4000,
                                     sessions_per_day=2.0)
    bootstrap_days: int = 4
    gen1_days: int = 4
    ab_days: int = 6
    feature_len: int = 48
    rt_buffer_len: int = 16
    rt_ingest_latency: int = 30
    # training
    train_epochs: int = 2
    train_batch: int = 128
    max_examples: int = 30000
    lr: float = 1e-3
    seed: int = 0
    # extra arms: feature staleness in seconds for the latency ablation
    latency_arms: Sequence[int] = ()


@dataclasses.dataclass
class ArmResult:
    name: str
    day_metrics: List[Dict]
    user_impressions: np.ndarray
    user_watches: np.ndarray

    @property
    def ctr(self) -> float:
        imp = sum(m["impressions"] for m in self.day_metrics)
        w = sum(m["slate_watches"] for m in self.day_metrics)
        return w / max(imp, 1)


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------

def train_ranker(events, model_cfg: ModelConfig, ab: ABConfig, cutoff: str,
                 log=print, device="cuda") -> Dict:
    """A ranker trained on ``events`` (``cutoff`` "midnight" or "fresh",
    as ``data.loader.build_examples``), on ``device``.

    It starts from f32 weights drawn by ``models.model.init_params`` from
    ``torch.Generator().manual_seed(ab.seed)`` (the JAX harness draws from
    ``PRNGKey(ab.seed)``, so the bits differ) and trains through
    ``training.train_loop.train`` with the JAX run's AdamW settings and
    the default bf16 ``param_dtype``. The JAX run also sets
    ``q_chunk=feature_len``; the port's ``TrainConfig`` has no
    ``q_chunk``, which only splits XLA attention's query axis into chunks
    to bound its memory and changes no row's result."""
    device = resolve_device(device)
    lcfg = LoaderConfig(n_items=ab.world.n_items, feature_len=ab.feature_len,
                        seed=ab.seed)
    ex = build_examples(events_to_arrays(events), lcfg, cutoff)
    n = len(ex["labels"])
    if n > ab.max_examples:
        keep = np.random.RandomState(ab.seed).choice(n, ab.max_examples, False)
        ex = {k: v[keep] for k, v in ex.items()}
    if log:
        log(f"[train:{cutoff}] {len(ex['labels'])} examples")
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=ab.lr, warmup_steps=50,
                          total_steps=ab.train_epochs * max(n, 1) // ab.train_batch,
                          weight_decay=0.01),
        remat=False)
    params = model_mod.init_params(
        model_cfg, torch.Generator().manual_seed(ab.seed),
        dtype=torch.float32, device=device)
    opt = init_opt_state(params)
    out = train(model_cfg, tcfg, params, opt,
                batches(ex, ab.train_batch, ab.train_epochs, ab.seed),
                log_every=100, log=log)
    return out["params"]


# ----------------------------------------------------------------------
# Platform assembly
# ----------------------------------------------------------------------

def make_platform(ab: ABConfig, model_cfg: ModelConfig, params, world: World,
                  history_events, *, policy: str, mode: str = "plain",
                  staleness: Optional[int] = None, device="cuda",
                  ) -> RecommenderPlatform:
    """One arm's platform on ``device``. The JAX harness's ``merge_impl``
    is gone: the port's merge runs its CUDA kernel on a card and its plain
    version on the CPU, chosen by the device."""
    device = resolve_device(device)
    w = ab.world
    store = BatchFeatureStore(FeatureStoreConfig(
        n_users=w.n_users, feature_len=ab.feature_len))
    cols = events_to_arrays(history_events)
    store.extend(cols["user"], cols["item"], cols["ts"])
    rts = RealtimeFeatureService(RealtimeConfig(
        n_users=w.n_users, buffer_len=ab.rt_buffer_len,
        ingest_latency=ab.rt_ingest_latency))
    # warm the realtime buffers with the trailing history (bounded retention
    # makes anything older invisible anyway)
    rts.extend(cols["user"], cols["item"], cols["ts"])
    inj = FeatureInjector(
        InjectionConfig(policy=policy, feature_len=ab.feature_len,
                        staleness=staleness),
        store, rts, device=device)
    pcfg = PipelineConfig(n_items=w.n_items, slate_size=w.slate_size,
                          serve_batch=256)
    return RecommenderPlatform(pcfg, model_cfg, params, inj,
                               world.popularity, mode=mode, device=device)


def run_arm(name: str, ab: ABConfig, platform: RecommenderPlatform,
            world: World, day_range, log=print) -> ArmResult:
    w = ab.world
    ui = np.zeros(w.n_users, np.int64)
    uw = np.zeros(w.n_users, np.int64)
    dm = []
    for day in day_range:
        t0 = time.time()
        _, m = simulate_day(world, day, platform.serve, platform.observe,
                            seed=ab.seed, serve_batch=platform.pcfg.serve_batch)
        ui += m.pop("user_impressions")
        uw += m.pop("user_watches")
        dm.append(m)
        if log:
            log(f"[{name}] day {day}: ctr={m['ctr']:.4f} "
                f"imp={m['impressions']} ({time.time() - t0:.1f}s)")
    return ArmResult(name, dm, ui, uw)


# ----------------------------------------------------------------------
# The full experiment
# ----------------------------------------------------------------------

def run_experiment(ab: ABConfig, *, model_cfg: Optional[ModelConfig] = None,
                   log=print, device="cuda") -> Dict:
    device = resolve_device(device)
    model_cfg = model_cfg or default_sim_model(ab.world.n_items)
    world = World(ab.world)
    all_events = []

    # ---- phase 0: bootstrap logs -------------------------------------
    serve0 = bootstrap_serve_fn(world, ab.seed)
    for day in range(ab.bootstrap_days):
        evs, m = simulate_day(world, day, serve0, lambda e: None, seed=ab.seed)
        all_events += evs
        if log:
            log(f"[bootstrap] day {day}: ctr={m['ctr']:.4f}")

    # ---- phase 1: generation-1 model, batch serving (feedback loop) ---
    m1 = train_ranker(all_events, model_cfg, ab, "midnight", log=log,
                      device=device)
    plat1 = make_platform(ab, model_cfg, m1, world, all_events,
                          policy="batch", device=device)
    # the platform-side observe hook: the harness's log collector
    # registers instead of monkey-patching the observe method
    plat1.on_observe.append(all_events.append)
    g1 = range(ab.bootstrap_days, ab.bootstrap_days + ab.gen1_days)
    run_arm("gen1", ab, plat1, world, g1, log=log)

    # ---- phase 2: generation-2 models ---------------------------------
    m2_batch = train_ranker(all_events, model_cfg, ab, "midnight", log=log,
                            device=device)
    m2_cons = train_ranker(all_events, model_cfg, ab, "fresh", log=log,
                           device=device)

    # ---- phase 3: paired A/B ------------------------------------------
    start = ab.bootstrap_days + ab.gen1_days
    ab_range = range(start, start + ab.ab_days)
    world_snapshot = copy.deepcopy(world)

    def arm(params, policy, **kw):
        return make_platform(ab, model_cfg, params, world, all_events,
                             policy=policy, device=device, **kw)

    arms: Dict[str, RecommenderPlatform] = {
        "control": arm(m2_batch, "batch"),
        "treatment": arm(m2_batch, "inject"),
        "consistent": arm(m2_cons, "inject", mode="consistent"),
    }
    for lam in ab.latency_arms:
        arms[f"stale_{lam}s"] = arm(m2_batch, "batch", staleness=lam)

    results: Dict[str, ArmResult] = {}
    for name, plat in arms.items():
        w_arm = copy.deepcopy(world_snapshot)
        results[name] = run_arm(name, ab, plat, w_arm, ab_range, log=log)

    # ---- analysis ------------------------------------------------------
    ctrl = results["control"]
    report = {"arms": {}, "tests": {}}
    for name, res in results.items():
        report["arms"][name] = summarize_arm(name, res.day_metrics)
        if name != "control":
            report["tests"][f"{name}_vs_control"] = paired_user_test(
                res.user_watches, res.user_impressions,
                ctrl.user_watches, ctrl.user_impressions, seed=ab.seed)
            imp_t = sum(m["impressions"] for m in res.day_metrics)
            w_t = sum(m["slate_watches"] for m in res.day_metrics)
            imp_c = sum(m["impressions"] for m in ctrl.day_metrics)
            w_c = sum(m["slate_watches"] for m in ctrl.day_metrics)
            z, p = two_proportion_z(w_t, imp_t, w_c, imp_c)
            report["tests"][f"{name}_vs_control"].update(
                {"z_pooled": z, "p_pooled": p})
    report["results"] = results
    return report
