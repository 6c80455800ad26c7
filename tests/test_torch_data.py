"""The port's ``data/`` package is the JAX package's, bit for bit.

The simulator (``World``, ``simulate_day`` under ``bootstrap_serve_fn``,
``events_to_arrays``) runs 3 seeded days in both packages: every event,
every metric, the per-user tallies and the world's state after each day
must be equal. The loader (``build_examples`` with both cutoffs,
``batches`` and ``serve_tokens_consistent``) must give equal arrays of
equal dtypes on those logs and on seeded padded features.
"""
import dataclasses

import numpy as np
import pytest

import repro.data.loader as jloader
import repro.data.synthetic as jsyn
import repro_torch.data.loader as tloader
import repro_torch.data.synthetic as tsyn

WORLD = dict(n_users=40, n_items=300, sessions_per_day=2.0)
DAYS = 3


def _equal(a, b, what):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, what


def _world_state(w):
    return {"item_genre": w.item_genre, "item_primary": w.item_primary,
            "popularity": w.popularity, "user_long": w.user_long,
            "intent": w.intent, "watched": [sorted(s) for s in w.watched],
            "continuations": [sorted(s) for s in w.continuations],
            "n_series": w.n_series, "n_episode_items": w.n_episode_items}


def _simulate(syn, seed):
    cfg = syn.WorldConfig(seed=seed, **WORLD)
    world = syn.World(cfg)
    serve = syn.bootstrap_serve_fn(world, seed)
    days, seen = [], []
    for day in range(DAYS):
        evs, m = syn.simulate_day(world, day, serve, seen.append, seed=seed,
                                  serve_batch=16)
        days.append((evs, m, _world_state(world)))
    return world, days, seen


@pytest.fixture(scope="module", params=[0, 7])
def logs(request):
    return request.param, _simulate(jsyn, request.param), \
        _simulate(tsyn, request.param)


def test_world_config_fields_equal():
    assert [(f.name, f.default) for f in dataclasses.fields(tsyn.WorldConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(jsyn.WorldConfig)]


def test_simulate_day_bit_equal(logs):
    seed, (jworld, jdays, jseen), (tworld, tdays, tseen) = logs
    _equal(_world_state(tworld), _world_state(jworld), "world")
    for day, ((je, jm, js), (te, tm, ts)) in enumerate(zip(jdays, tdays)):
        assert [dataclasses.astuple(e) for e in te] == \
            [dataclasses.astuple(e) for e in je], f"seed {seed} day {day}"
        _equal(tm, jm, f"metrics, day {day}")
        _equal(ts, js, f"world state after day {day}")
    # the observe hook saw every event, in order
    assert [dataclasses.astuple(e) for e in tseen] == \
        [dataclasses.astuple(e) for e in jseen]
    assert sum(len(d[0]) for d in tdays) == len(tseen) > 0


def test_events_to_arrays_bit_equal(logs):
    _, (_, jdays, _), (_, tdays, _) = logs
    jev = [e for d in jdays for e in d[0]]
    tev = [e for d in tdays for e in d[0]]
    _equal(tsyn.events_to_arrays(tev), jsyn.events_to_arrays(jev), "arrays")
    _equal(tsyn.events_to_arrays([]), jsyn.events_to_arrays([]), "empty")


def test_session_schedule_bit_equal():
    cfg = tsyn.WorldConfig(**WORLD)
    for day in range(DAYS):
        got = tsyn.session_schedule(cfg, day, np.random.RandomState(day))
        want = jsyn.session_schedule(jsyn.WorldConfig(**WORLD), day,
                                     np.random.RandomState(day))
        assert got == want


@pytest.mark.parametrize("cutoff", ["midnight", "fresh"])
def test_build_examples_and_batches_bit_equal(logs, cutoff):
    seed, (_, jdays, _), _ = logs
    cols = jsyn.events_to_arrays([e for d in jdays for e in d[0]])
    kw = dict(n_items=WORLD["n_items"], feature_len=12, recent_len=4,
              seed=seed)
    want = jloader.build_examples(cols, jloader.LoaderConfig(**kw), cutoff)
    got = tloader.build_examples(cols, tloader.LoaderConfig(**kw), cutoff)
    _equal(got, want, f"examples ({cutoff})")
    assert len(got["labels"]) > 16
    if cutoff == "fresh":  # the SEP segment is really there
        assert (got["tokens"] == tloader.sep_token(WORLD["n_items"])).any()
    jb = list(jloader.batches(want, 8, 2, seed))
    tb = list(tloader.batches(got, 8, 2, seed))
    assert len(tb) == len(jb) == 2 * (len(want["labels"]) // 8)
    for i, (t, j) in enumerate(zip(tb, jb)):
        _equal(t, j, f"batch {i}")
    with pytest.raises(ValueError, match="unknown cutoff"):
        tloader.build_examples(cols, tloader.LoaderConfig(**kw), "noon")


def test_serve_tokens_consistent_bit_equal():
    rng = np.random.RandomState(3)
    b, lb, lr, k, n_items = 24, 20, 8, 16, 500
    bf = (rng.randint(0, n_items, (b, lb)), rng.randint(0, 10**6, (b, lb)),
          (rng.rand(b, lb) < 0.6).astype(np.int32))
    rf = (rng.randint(0, n_items, (b, lr)), rng.randint(0, 10**6, (b, lr)),
          (rng.rand(b, lr) < 0.5).astype(np.int32))
    bf[2][:4] = 0                 # no batch history
    rf[2][4:8] = 0                # no recent events
    rf[2][8:10] = 1               # a full recent segment
    got = tloader.serve_tokens_consistent(bf, rf, n_items, k)
    want = jloader.serve_tokens_consistent(bf, rf, n_items, k)
    for g, w in zip(got, want):
        _equal(g, w, "consistent tokens")
    # every row ends its batch segment with SEP
    assert (got[0] == tloader.sep_token(n_items)).sum(1).tolist() == [1] * b
