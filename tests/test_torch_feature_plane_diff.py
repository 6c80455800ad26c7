"""Differential tests of the port's feature plane against its loop oracle.

``tests/test_feature_plane_diff.py``'s cases, run against the port: the
array-backed ``BatchFeatureStore``/``RealtimeFeatureService`` of
``repro_torch.core`` must be bit for bit the port's loop oracles
(``repro_torch.core._reference``) on randomized event streams — duplicate
deliveries, identical timestamps, out-of-order ingest, empty users. The
port's oracles are fed the same streams as the JAX package's
(``repro.core._reference``) and must answer bit for bit as they do.
"""
import numpy as np
import pytest

import repro.core._reference as jref
from repro_torch.core._reference import (ReferenceBatchFeatureStore,
                                         ReferenceRealtimeFeatureService)
from repro_torch.core.feature_store import (BatchFeatureStore,
                                            FeatureStoreConfig)
from repro_torch.core.realtime import RealtimeConfig, RealtimeFeatureService

DAY = 86400


def _assert_features_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


class _Triple:
    """The port's store, the port's oracle and the JAX package's oracle,
    fed alike; every read must agree three ways."""

    def __init__(self, vec, ref, jax_ref):
        self.all = (vec, ref, jax_ref)

    def __getattr__(self, name):
        fns = [getattr(o, name) for o in self.all]

        def call(*a, **kw):
            outs = [f(*a, **kw) for f in fns]
            if outs[0] is not None and not isinstance(outs[0], (int, list)):
                for o in outs[1:]:
                    _assert_features_equal(outs[0], o)
            else:
                assert outs[1:] == outs[:1] * 2, name
            return outs[0]
        return call


def _batch(cfg, oracle_cfg=None):
    oc = oracle_cfg or cfg
    return _Triple(BatchFeatureStore(cfg), ReferenceBatchFeatureStore(oc),
                   jref.ReferenceBatchFeatureStore(oc))


def _realtime(cfg):
    return _Triple(RealtimeFeatureService(cfg),
                   ReferenceRealtimeFeatureService(cfg),
                   jref.ReferenceRealtimeFeatureService(cfg))


def _random_stream(rng, n_users, n_events, max_ts):
    users = rng.randint(0, n_users, n_events)
    items = rng.randint(0, 40, n_events)
    tss = rng.randint(0, max_ts, n_events)
    # inject duplicate deliveries (at-least-once) and ts ties
    for _ in range(n_events // 4):
        i = rng.randint(n_events)
        j = rng.randint(n_events)
        users[i], items[i], tss[i] = users[j], items[j], tss[j]
    return users, items, tss


@pytest.mark.parametrize("seed", range(8))
def test_batch_store_matches_reference(seed):
    rng = np.random.RandomState(seed)
    n_users = rng.randint(1, 20)
    k = rng.randint(1, 12)
    window = int(rng.choice([1000, 3 * DAY, 30 * DAY]))
    cfg = FeatureStoreConfig(n_users=n_users, feature_len=k, window=window)
    vec, ref, jr = (BatchFeatureStore(cfg), ReferenceBatchFeatureStore(cfg),
                    jref.ReferenceBatchFeatureStore(cfg))
    users, items, tss = _random_stream(rng, n_users, rng.randint(0, 400),
                                       5 * DAY)
    vec.extend(users, items, tss)
    for u, it, t in zip(users, items, tss):
        ref.append(int(u), int(it), int(t))
        jr.append(int(u), int(it), int(t))
    both = _Triple(vec, ref, jr)

    # users with no events and repeated query users are both exercised
    q = rng.randint(0, n_users, rng.randint(0, 30))
    for cutoff in [0, 17, DAY, int(rng.randint(0, 6 * DAY))]:
        both.lookup_at_cutoff(q, cutoff)
    for snap_ts in [DAY, 2 * DAY + 13]:
        both.run_snapshot(snap_ts)
    for now in [0, DAY, DAY + 1, 3 * DAY]:
        both.lookup(q, now)
        both.latest_snapshot_ts(now)
    for u in range(n_users):
        both.user_events(u)


@pytest.mark.parametrize("seed", range(8))
def test_realtime_matches_reference(seed):
    rng = np.random.RandomState(100 + seed)
    n_users = rng.randint(1, 16)
    cfg = RealtimeConfig(
        n_users=n_users, buffer_len=rng.randint(1, 10),
        ingest_latency=int(rng.choice([0, 30, 300])),
        retention=int(rng.choice([500, 3600, DAY])))
    svc = _realtime(cfg)
    users, items, tss = _random_stream(rng, n_users, rng.randint(0, 600),
                                       2 * DAY)
    # interleave single ingest and redelivery; arrival order matters for
    # the bounded buffer, so feed every service identically
    for u, it, t in zip(users, items, tss):
        svc.ingest(int(u), int(it), int(t))
        if rng.rand() < 0.1:  # redelivery
            svc.ingest(int(u), int(it), int(t))
    counts = {o.events_ingested for o in svc.all}
    assert len(counts) == 1
    q = rng.randint(0, n_users, rng.randint(0, 40))
    for now in [0, 1000, int(rng.randint(0, 3 * DAY)), 3 * DAY]:
        svc.lookup(q, now)


def test_realtime_memory_bounded():
    """Ring storage never grows past n_users * buffer_len regardless of
    ingest volume, and stays exact under sustained overwrite."""
    cfg = RealtimeConfig(n_users=3, buffer_len=4, ingest_latency=0,
                         retention=10**6)
    svc = _realtime(cfg)
    rng = np.random.RandomState(7)
    for i in range(300):
        u, it, t = rng.randint(3), rng.randint(20), rng.randint(0, 5000)
        svc.ingest(u, it, t)
        if i % 37 == 0:
            svc.lookup(np.arange(3), 5000)
    vec = svc.all[0]
    assert vec._items.shape == (3, 4) and vec._ts.shape == (3, 4)
    svc.lookup(np.arange(3), 2500)


def test_realtime_extend_matches_sequential_ingest():
    """Columnar bulk ingest == one-by-one ingest, including batches that
    overflow a user's ring several times over."""
    rng = np.random.RandomState(11)
    cfg = RealtimeConfig(n_users=4, buffer_len=3, ingest_latency=0,
                         retention=10**6)
    a, b = RealtimeFeatureService(cfg), RealtimeFeatureService(cfg)
    oracle = jref.ReferenceRealtimeFeatureService(cfg)
    for _ in range(5):  # several batches: cursors carry across batches
        u = rng.randint(0, 4, 25)
        it = rng.randint(0, 30, 25)
        t = rng.randint(0, 1000, 25)
        a.extend(u, it, t)
        for x, y, z in zip(u, it, t):
            b.ingest(int(x), int(y), int(z))
            oracle.ingest(int(x), int(y), int(z))
        q = np.arange(4)
        _assert_features_equal(a.lookup(q, 1000), b.lookup(q, 1000))
        _assert_features_equal(a.lookup(q, 1000), oracle.lookup(q, 1000))
    assert a.events_ingested == b.events_ingested == oracle.events_ingested


def test_batch_store_interleaved_appends_match_reference():
    """The serve loop's observe/lookup interleaving (reads racing an
    unsorted pending suffix) stays bit-for-bit with the oracles."""
    rng = np.random.RandomState(13)
    cfg = FeatureStoreConfig(n_users=8, feature_len=6, window=3 * DAY)
    store = _batch(cfg)
    q = rng.randint(0, 8, 12)
    for i in range(200):
        u, it, t = rng.randint(8), rng.randint(40), rng.randint(0, 4 * DAY)
        store.append(u, it, t)
        if i % 9 == 0:
            store.lookup_at_cutoff(q, int(rng.randint(0, 5 * DAY)))


def test_snapshot_retention_evicts_but_stays_consistent():
    cfg = FeatureStoreConfig(n_users=3, feature_len=4, snapshot_retention=2)
    full = FeatureStoreConfig(n_users=3, feature_len=4)
    store = _batch(cfg, oracle_cfg=full)
    rng = np.random.RandomState(5)
    for _ in range(30):
        u, it, t = rng.randint(3), rng.randint(20), rng.randint(0, 5 * DAY)
        store.append(u, it, t)
    for d in range(1, 6):
        store.run_snapshot(d * DAY)
    vec = store.all[0]
    assert len(vec._snapshots) == 2           # arrays bounded
    assert len(vec._snapshot_times) == 5      # schedule intact
    q = np.array([0, 1, 2])
    # reads of evicted generations recompute from the log, exactly
    for now in [DAY, 2 * DAY + 5, 5 * DAY]:
        store.lookup(q, now)


def test_empty_stores_agree():
    cfg = FeatureStoreConfig(n_users=5, feature_len=6)
    store = _batch(cfg)
    q = np.array([0, 4, 4])
    store.lookup(q, DAY)
    store.lookup_at_cutoff(q, DAY)
    store.run_snapshot(DAY)
    store.lookup(q, DAY + 1)


def test_append_events_compat():
    class Ev:
        def __init__(self, u, i, t):
            self.user, self.item, self.ts = u, i, t

    evs = [Ev(0, 3, 100), Ev(1, 4, 50), Ev(0, 5, 75)]
    store = _batch(FeatureStoreConfig(n_users=2, feature_len=4))
    store.append_events(evs)
    store.lookup_at_cutoff(np.array([0, 1]), 200)
