"""The port's host feature plane is bit for bit the JAX package's.

``repro_torch.core.{event_log,feature_store,realtime}`` are copies of the
numpy-only modules of ``repro``; the same seeded stream
(``conftest.seed_events``) goes into both, through a snapshot rollover,
and every read must agree exactly.
"""
import numpy as np
import pytest

import repro.core.feature_store as jfs
import repro.core.realtime as jrt
import repro_torch.core.feature_store as tfs
import repro_torch.core.realtime as trt
from conftest import DAY, FEATURE_LEN, N_USERS, seed_events

STORE_CFGS = {
    "unbounded": {},
    "tiered": dict(log_window=DAY, log_retention_windows=3),
    "retention2": dict(snapshot_retention=2),
}


def _equal(a, b, what):
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=what)
        assert np.asarray(x).dtype == np.asarray(y).dtype, what


def _stores(pkg_fs, pkg_rt, store_kw, events):
    store = pkg_fs.BatchFeatureStore(pkg_fs.FeatureStoreConfig(
        n_users=N_USERS, feature_len=FEATURE_LEN, **store_kw))
    rts = pkg_rt.RealtimeFeatureService(pkg_rt.RealtimeConfig(
        n_users=N_USERS, buffer_len=8, ingest_latency=30))
    store.extend(*events)
    rts.extend(*events)
    return store, rts


@pytest.mark.parametrize("name", sorted(STORE_CFGS))
def test_stores_bit_equal_through_rollover(name):
    us, its, tss = seed_events(seed=3)
    j_store, j_rts = _stores(jfs, jrt, STORE_CFGS[name], (us, its, tss))
    t_store, t_rts = _stores(tfs, trt, STORE_CFGS[name], (us, its, tss))
    users = np.arange(N_USERS)
    rng = np.random.RandomState(7)
    for day in (3, 4, 6):  # day 6 catches up over a missed boundary
        now = day * DAY + 500
        for store in (j_store, t_store):
            store.maybe_run_due_snapshots(now)
            if store.cfg.log_window:
                store.log.compact(now)
        assert j_store._snapshot_times == t_store._snapshot_times
        _equal(j_store.lookup(users, now), t_store.lookup(users, now),
               f"lookup day {day}")
        _equal(j_store.lookup_at_cutoff(users, now - 77),
               t_store.lookup_at_cutoff(users, now - 77), f"cutoff day {day}")
        _equal(j_rts.lookup(users, now), t_rts.lookup(users, now),
               f"realtime day {day}")
        # fresh events after the boundary, trickled one at a time
        for _ in range(60):
            u, i, t = rng.randint(N_USERS), rng.randint(300), \
                now + rng.randint(0, 3000)
            for store, rts in ((j_store, j_rts), (t_store, t_rts)):
                store.append(u, i, t)
                rts.ingest(u, i, t)
    gens = j_store._snapshot_times
    assert gens == t_store._snapshot_times and len(gens) >= 3
    a, b = j_store.changed_users_between(gens[-2], gens[-1]), \
        t_store.changed_users_between(gens[-2], gens[-1])
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


def test_incremental_builder_bit_equal():
    """The budgeted incremental snapshot build agrees across packages."""
    us, its, tss = seed_events(seed=5)
    out = []
    for pkg_fs, pkg_rt in ((jfs, jrt), (tfs, trt)):
        store, _ = _stores(pkg_fs, pkg_rt, {}, (us, its, tss))
        store.run_snapshot(4 * DAY)
        store.extend(us[:50], its[:50], np.full(50, 4 * DAY + 10))
        builder = store.begin_snapshot(5 * DAY)
        while builder.step(7):
            pass
        out.append((store.lookup(np.arange(N_USERS), 5 * DAY + 1),
                    store.changed_users_between(4 * DAY, 5 * DAY)))
    _equal(out[0][0], out[1][0], "incremental build")
    np.testing.assert_array_equal(out[0][1], out[1][1])
