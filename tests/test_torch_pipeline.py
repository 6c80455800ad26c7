"""The port's ``RecommenderPlatform`` serves the JAX package's slates.

Both platforms get the same seeded event stream, the same snapshot
schedule, the same fresh events after it and the same weights (JAX
``init_params``, converted). The run includes a cold user (no events at
all, so retrieval similarities are all 0) and a uniform popularity prior,
so every top-k meets ties; the port breaks them as ``jax.lax.top_k`` does.
Slates must be equal, fp32 with TF32 off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from conftest import DAY, FEATURE_LEN, N_ITEMS, N_USERS, seed_events
from repro.core.ab import default_sim_model
from repro.core.pipeline import _serve_core as jax_serve_core
from repro.models.model import init_params as jax_init_params
from repro_torch.configs import ModelConfig
from repro_torch.core.pipeline import _serve_core, items_to_tokens
from repro_torch.models.model import Ranker
from repro_torch.weights import params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
COLD = N_USERS  # one user past the seeded ones: never sees an event


@pytest.fixture(scope="module")
def model():
    jcfg = default_sim_model(N_ITEMS)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _platform(pkg, policy, cfg, params, pop, **kw):
    store = pkg.BatchFeatureStore(pkg.FeatureStoreConfig(
        n_users=N_USERS + 1, feature_len=FEATURE_LEN))
    rts = pkg.RealtimeFeatureService(pkg.RealtimeConfig(
        n_users=N_USERS + 1, buffer_len=8, ingest_latency=0))
    us, its, tss = seed_events(seed=11, t_hi=4 * DAY)
    store.extend(us, its, tss)
    rts.extend(us, its, tss)
    inj = pkg.FeatureInjector(pkg.InjectionConfig(
        policy=policy, feature_len=FEATURE_LEN), store, rts, **kw)
    pcfg = pkg.PipelineConfig(n_items=N_ITEMS, slate_size=5, n_candidates=32,
                              recall_primary=24, recall_popular=8,
                              serve_batch=16)
    return pkg.RecommenderPlatform(pcfg, cfg, params, inj, pop, **kw)


@pytest.mark.parametrize("policy", ["batch", "inject"])
@pytest.mark.parametrize("prior", ["uniform", "zipf"])
def test_platform_slates_equal_jax(model, policy, prior):
    jcfg, jparams, cfg, params = model
    pop = np.full(N_ITEMS, 1.0 / N_ITEMS) if prior == "uniform" else \
        1.0 / np.arange(1, N_ITEMS + 1) / np.sum(1.0 / np.arange(1, N_ITEMS + 1))
    jplat = _platform(jcore, policy, jcfg, jparams, pop)
    tplat = _platform(tcore, policy, cfg, params, pop, device="cpu")
    rng = np.random.RandomState(5)
    now = 4 * DAY + 100
    for step in range(3):
        # fresh events after the snapshot, the same on both platforms
        for _ in range(40):
            u, i, t = rng.randint(N_USERS), rng.randint(N_ITEMS), \
                now + rng.randint(0, 600)
            for plat in (jplat, tplat):
                plat.observe(_Ev(u, i, t))
        now += 900
        users = np.r_[COLD, rng.choice(N_USERS, 12, replace=False)]
        want = jplat.serve(users, np.full(len(users), now))
        got = tplat.serve(users, np.full(len(users), now))
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
    assert tplat.injector.merge_calls == jplat.injector.merge_calls
    assert (tplat.injector.merge_calls > 0) == (policy == "inject")


@dataclasses.dataclass
class _Ev:
    user: int
    item: int
    ts: int


def test_serve_core_ties_match_jax(model):
    """Cold rows (all-padding history), a zero prior and duplicate
    candidates: retrieval and slate order agree with ``lax.top_k``'s."""
    jcfg, jparams, cfg, params = model
    pcfg = tcore.PipelineConfig(n_items=N_ITEMS, slate_size=5,
                                recall_primary=24, recall_popular=8,
                                serve_batch=4)
    jpcfg = jcore.PipelineConfig(**dataclasses.asdict(pcfg))
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, N_ITEMS + 1, (4, 16)).astype(np.int32)
    valid = np.ones((4, 16), np.int32)
    valid[0] = 0
    valid[1, :12] = 0
    tokens[valid == 0] = 0
    pop = np.zeros(N_ITEMS, np.float32)
    want = jax_serve_core(jparams, jnp.asarray(tokens), jnp.asarray(valid),
                          jnp.asarray(pop), cfg=jcfg, pcfg=jpcfg)
    got = _serve_core(Ranker(cfg, params), torch.from_numpy(tokens),
                      torch.from_numpy(valid), torch.from_numpy(pop),
                      pcfg=pcfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_items_to_tokens():
    items = np.array([[4, 0, 9]])
    valid = np.array([[1, 0, 1]])
    np.testing.assert_array_equal(items_to_tokens(items, valid),
                                  [[5, 0, 10]])


@pytest.mark.parametrize("policy,staleness", [
    ("batch", None), ("inject", None), ("fresh", None), ("decay", None),
    ("inject", 3600)])
def test_injector_equal_jax(policy, staleness):
    """``FeatureInjector``'s features, generation, fresh suffixes (events
    and tokens) and ``decay_scores`` agree bit for bit with the JAX
    package's, before and after a snapshot and with redelivered events."""
    from repro.core.injection import decay_scores as jax_decay_scores
    from repro_torch.core.injection import decay_scores

    us, its, tss = seed_events(seed=2, t_hi=3 * DAY)
    injs = []
    for pkg, kw in ((jcore, {}), (tcore, {"device": "cpu"})):
        store = pkg.BatchFeatureStore(pkg.FeatureStoreConfig(
            n_users=N_USERS, feature_len=FEATURE_LEN))
        rts = pkg.RealtimeFeatureService(pkg.RealtimeConfig(
            n_users=N_USERS, buffer_len=8, ingest_latency=5))
        store.extend(us, its, tss)
        rts.extend(us, its, tss)
        for u, i, t in ((1, 7, 3 * DAY + 50),) * 2 + ((1, 8, 3 * DAY + 60),):
            rts.ingest(u, i, t)  # a redelivered event and a fresh one
        injs.append(pkg.FeatureInjector(pkg.InjectionConfig(
            policy=policy, feature_len=FEATURE_LEN, staleness=staleness),
            store, rts, **kw))
    users = np.arange(N_USERS)
    for now in (3 * DAY - 10, 3 * DAY + 100):
        for inj in injs:
            inj.batch.maybe_run_due_snapshots(now)
        want, got = (inj.features(users, now) for inj in injs)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype
        assert injs[0].generation(now) == injs[1].generation(now)
        assert injs[0].fresh_suffix(users, now) == \
            injs[1].fresh_suffix(users, now)
        assert injs[0].fresh_suffix_tokens(users, now, cap=2) == \
            injs[1].fresh_suffix_tokens(users, now, cap=2)
        np.testing.assert_array_equal(
            decay_scores(got, now, DAY, N_ITEMS),
            jax_decay_scores(want, now, DAY, N_ITEMS))
    assert injs[0].merge_calls == injs[1].merge_calls
