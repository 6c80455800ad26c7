"""The port's ``Gateway`` against the JAX package's, request by request.

Each case runs the JAX ``Gateway`` over the JAX ``ServingEngine`` and the
port's ``Gateway`` over the port's engine (``device="cpu"``, the same fp32
weights carried across with ``weights.params_from_numpy``) on feature
planes built from the same events, and feeds both the same operations.
The engines are the shared ``tiny-test`` one (``conftest.tiny_engine``:
``max_batch`` 4, ``prefill_len`` 32, ``inject_len`` 8) and, in one case,
``reduced(mamba2-780m)`` at the same shapes, so SSM caches go through the
host LRU. Every ticket must match: equal slates, scores within 1e-5
absolute and relative (XLA and torch order their f32 sums differently;
decay rows are numpy on both sides and equal), and equal telemetry. The
``stats()`` of the two gateways must be equal on every counter that is
not a wall-clock reading (``build_time_s``, ``build_slice_max_s``,
``patch_install_max_ms``), byte accounting included.

Each scenario runs once with the host LRU and once, in
``test_pooled_backend``, with the paged state pool on both sides
(``pool_slots`` equal to the scenario's entry budget); the pooled
property of ``tests/test_property.py`` runs here on seeded schedules.

Schedules are scripted or drawn from a seeded numpy RNG, never searched
and never timed: the background build case waits for the build's worker
thread (a synchronisation, not a sleep) so both gateways install the new
generation on the same tick. Rollover counts are held against each
other, never against a fixed number.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DAY, N_ITEMS, N_USERS, tiny_engine
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models.model import init_params as jax_init_params
from repro.serving import api as jax_api
from repro.serving.engine import ServingConfig as JaxServingConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.scheduler import Gateway as JaxGateway
from repro.serving.scheduler import ServerConfig as JaxServerConfig
from repro_torch.serving import Gateway, ServerConfig, api
from torch_port import make_injector, port_engine

TOL = dict(atol=1e-5, rtol=1e-5)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T0 = 5 * DAY + 100                 # one step past the first daily boundary
WALL_CLOCK = ("build_time_s", "build_slice_max_s")


@pytest.fixture(scope="module")
def engines():
    jeng = tiny_engine()
    return jeng, port_engine(jeng)


@pytest.fixture(scope="module")
def mamba_engines():
    jcfg = jax_reduced(jax_get_config("mamba2-780m"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jeng = JaxServingEngine(jcfg, jparams, JaxServingConfig(
        max_batch=4, prefill_len=32, inject_len=8, cache_capacity=64))
    return jeng, port_engine(jeng)


class Pair:
    """A JAX Gateway and the port's, fed the same operations. Requests
    are given as dicts of ``Request`` fields and built in each package;
    any other Gateway method is called on both with the same arguments.
    Every ticket either side returns is kept for ``check``."""

    def __init__(self, engines, policy="inject", events=None,
                 store_kw=None, pool=False, **cfg_kw):
        cfg_kw.setdefault("slate_len", 3)
        cfg_kw.setdefault("cache_entries", 64)
        if pool:
            cfg_kw.setdefault("pool_slots", cfg_kw["cache_entries"])
        store_kw = store_kw or {}
        jeng, eng = engines
        self.gws = (
            JaxGateway(jeng, make_injector("repro", policy, events,
                                           **store_kw),
                       JaxServerConfig(**cfg_kw)),
            Gateway(eng, make_injector("repro_torch", policy, events,
                                       **store_kw), ServerConfig(**cfg_kw)))
        self.tickets = ([], [])

    def submit(self, **spec):
        for gw, mod, out in zip(self.gws, (jax_api, api), self.tickets):
            out.append(gw.submit(mod.Request(**spec)))

    def submit_many(self, specs):
        for gw, mod, out in zip(self.gws, (jax_api, api), self.tickets):
            out.extend(gw.submit_many([mod.Request(**s) for s in specs]))

    def __getattr__(self, name):
        def call(*args, **kw):
            outs = [getattr(gw, name)(*args, **kw) for gw in self.gws]
            if name in ("flush", "tick", "drain", "poll"):
                for j, t in zip(*outs):
                    assert j.request_id == t.request_id
            else:
                assert outs[0] == outs[1], (name, outs)
            return outs[1]
        return call

    def check(self):
        """Every ticket so far, and the stats."""
        jt, tt = self.tickets
        assert len(jt) == len(tt)
        for j, t in zip(jt, tt):
            assert j.request_id == t.request_id and j.done == t.done
            if not j.done:
                continue
            jr, tr = j.response, t.response
            assert dataclasses.asdict(tr.telemetry) == \
                dataclasses.asdict(jr.telemetry)
            assert tr.shed == jr.shed
            assert tr.slate.dtype == jr.slate.dtype == np.int32
            np.testing.assert_array_equal(tr.slate, jr.slate)
            assert tr.scores.dtype == np.float32
            assert tr.scores.shape == jr.scores.shape
            if tr.telemetry.path == "decay":
                np.testing.assert_array_equal(tr.scores, jr.scores)
            else:
                np.testing.assert_allclose(tr.scores, jr.scores, **TOL)
        assert stats(self.gws[1]) == stats(self.gws[0])
        return self.gws[1].stats()


def stats(gw):
    d = gw.stats().as_dict()
    d.pop("patch_install_max_ms")
    for key in WALL_CLOCK:
        d["rollover"].pop(key)
    return d


def _reqs(users, now, **kw):
    return [dict(user=int(u), now=int(now), **kw) for u in users]


# ----------------------------------------------------------------------
# Scripted cases
# ----------------------------------------------------------------------

def test_waves_and_trickle(engines, pool=False):
    """Waves (``submit_many`` + ``flush``, several panes, a repeated
    user, cache-aware hit-first partitioning) and a trickle of single
    submits with pane-full flushes, before and after fresh events."""
    p = Pair(engines, pool=pool)
    users = [1, 2, 3, 4, 5, 6, 2, 9, 10]
    p.submit_many(_reqs(users, T0))
    p.flush(T0)
    p.observe_many([1, 2, 9, 11], [5, 6, 7, 8], [T0 - 40, T0 - 30, T0 - 20,
                                                  T0 - 10])
    p.submit_many(_reqs([11, 1, 2, 12, 3, 9, 13, 4, 5], T0 + 5))
    p.flush(T0 + 5)
    for i, u in enumerate([9, 2, 14, 1, 15, 6]):
        p.submit(user=u, now=T0 + 10 + i)
    p.poll()
    p.flush(T0 + 20)
    st = p.check()
    assert st.paths["inject"] > 0 and st.paths["cached"] > 0
    assert st.cache["hits"] > 0 and st.cache["misses"] > 0


def test_max_wait_zero_partial_panes(engines, pool=False):
    p = Pair(engines, pool=pool, max_wait=0)
    p.observe_many([3, 4], [7, 8], [T0 - 5, T0 - 4])
    for i, u in enumerate([3, 4, 3, 5, 6, 7, 4]):
        p.submit(user=u, now=T0 + i)
    p.submit_many(_reqs([8, 9, 10, 11, 12, 3], T0 + 10))
    p.tick(T0 + 11)
    p.drain(T0 + 12)
    st = p.check()
    assert st.panes > st.requests // 4


def test_mixed_policy_panes(engines, pool=False):
    """batch, inject, fresh and decay rows share panes; fresh rows are
    ephemeral admissions, decay rows never reach the engine."""
    p = Pair(engines, pool=pool)
    p.observe_many([1, 2, 3, 4], [11, 12, 13, 14], [T0 - 9] * 4)
    pols = ["batch", "inject", "fresh", "decay", None]
    specs = [dict(user=u, now=T0, policy=pols[i % 5])
             for i, u in enumerate([1, 2, 3, 4, 1, 2, 3, 4, 5, 6, 7])]
    p.submit_many(specs)
    p.flush(T0)
    p.submit_many([dict(user=u, now=T0 + 1, policy="fresh")
                   for u in (1, 2, 3)])
    p.flush(T0 + 1)
    p.submit_many([dict(user=u, now=T0 + 2, policy="decay")
                   for u in (1, 5)])
    p.flush(T0 + 2)
    st = p.check()
    assert all(st.paths[k] > 0 for k in ("prefill", "decay"))


def test_per_row_slate_len(engines, pool=False):
    p = Pair(engines, pool=pool, slate_len=2)
    p.observe_many([1, 2], [5, 6], [T0 - 9] * 2)
    lens = [1, 5, None, 3, 2, None, 4]
    p.submit_many([dict(user=u, now=T0, slate_len=k)
                   for u, k in zip([1, 2, 3, 1, 4, 5, 6], lens)])
    p.flush(T0)
    p.check()
    assert [len(t.response.slate) for t in p.tickets[1]] == \
        [k or 2 for k in lens]


def test_deadline_flush_and_shedding(engines, pool=False):
    """A deadline flushes a partial pane on the clock; with a service
    model and ``shed_policy="deadline"`` late requests are shed at submit
    and at flush, and served-late ones count as misses."""
    p = Pair(engines, pool=pool)
    p.submit(user=1, now=T0, deadline=T0 + 30)
    p.submit(user=2, now=T0 + 1)
    p.tick(T0 + 29)
    p.tick(T0 + 30)
    p.check()
    s = Pair(engines, pool=pool, pane_service_time=20,
             shed_policy="deadline")
    s.submit_many([dict(user=u, now=T0, deadline=T0 + d) for u, d in
                   zip(range(10), [15, 100, 30, 45, 60, 19, 80, 25, 90,
                                   200])])
    s.submit(user=11, now=T0 + 1, deadline=T0 + 10)
    s.submit(user=12, now=T0 + 2)
    s.flush(T0 + 40)
    s.drain()
    st = s.check()
    assert st.shed > 0 and st.deadline_flushes == 0


@pytest.mark.parametrize("budget", ["entries", "bytes"])
def test_lru_eviction(engines, budget, pool=False):
    """Eviction under ``cache_entries`` and under the byte budget: the
    port's entries must count the same bytes as the JAX package's. A
    pool's slot count is the budget in entries; it cannot be below
    ``max_batch`` (4), so the byte budget of 3.5 entries becomes 4
    slots."""
    probe = Pair(engines, pool=pool)
    probe.submit_many(_reqs([0], T0))
    probe.flush(T0)
    entry = probe.gws[1].cache.bytes_per_shard
    assert entry == probe.gws[0].cache.bytes_per_shard > 0
    kw = ({"cache_entries": 5} if budget == "entries"
          else {"cache_bytes": 3 * entry + entry // 2})
    if pool and budget == "bytes":
        kw["pool_slots"] = max(kw["cache_bytes"] // entry,
                               engines[1].scfg.max_batch)
    p = Pair(engines, pool=pool, **kw)
    rng = np.random.RandomState(7)
    for wave in range(4):
        p.submit_many(_reqs(rng.randint(0, 12, 6), T0 + wave))
        p.flush(T0 + wave)
    p.warm(np.arange(20, 30), T0 + 5)
    st = p.check()
    assert st.cache["evictions"] > 0


def test_warm_handoff_rollover_with_rewarm(engines, pool=False):
    """A warm pass, then a generation roll with a certified handoff:
    unchanged users rekeyed, changed users retained then re-warmed by
    ``rewarm_budget`` on later ticks; the next wave serves from both."""
    p = Pair(engines, pool=pool, rewarm_budget=2, cache_entries=16)
    users = list(range(10))
    p.warm(users, T0)
    p.submit_many(_reqs(users, T0))
    p.flush(T0)
    p.observe_many([0, 1, 2, 3], [20, 21, 22, 23], [T0 + 500] * 4)
    p.tick(T0 + DAY)
    for k in range(3):
        p.tick(T0 + DAY + 10 + k)
    p.observe_many([4, 5], [30, 31], [T0 + DAY + 20] * 2)
    p.submit_many(_reqs(users, T0 + DAY + 30))
    p.flush(T0 + DAY + 30)
    st = p.check()
    assert st.rollover.rekeyed > 0 and st.rollover.rebuilt > 0


def test_snapshot_build_budget(engines, pool=False):
    """The incremental daily job: the roll lands over several ticks while
    serving reads the previous generation."""
    p = Pair(engines, pool=pool, snapshot_build_budget=3)
    users = list(range(8))
    p.submit_many(_reqs(users, T0))
    p.flush(T0)
    p.observe_many(users, np.arange(8) + 20, np.full(8, T0 + 500))
    for k in range(8):
        p.tick(T0 + DAY + k)
        p.submit_many(_reqs([k, k + 1], T0 + DAY + k))
        p.flush(T0 + DAY + k)
    st = p.check()
    assert st.rollover.build_steps >= 2


def test_background_build(engines, pool=False):
    """``background_build``: the worker thread builds the generation with
    numpy only and the install happens on a serving tick. Each store's
    builder is waited for as it starts (no sleep), so both gateways
    install on the same tick."""
    p = Pair(engines, pool=pool, background_build=True)
    for gw in p.gws:
        store = gw.injector.batch
        begin = store.begin_snapshot_background

        def started(ts, begin=begin):
            b = begin(ts)
            assert b._built.wait(60)
            return b
        store.begin_snapshot_background = started
    users = list(range(8))
    p.submit_many(_reqs(users, T0))
    p.flush(T0)
    p.observe_many(users[:3], [20, 21, 22], [T0 + 500] * 3)
    p.tick(T0 + DAY)
    p.submit_many(_reqs(users, T0 + DAY + 5))
    p.flush(T0 + DAY + 5)
    st = p.check()
    assert st.rollover.build_steps > 0
    assert p.gws[1].injector.generation(T0 + DAY) == 6 * DAY


def test_delta_rewarm(engines, pool=False):
    """O(delta) re-warm: changed users whose new snapshot row extends the
    old one are rekeyed with the delta as pending inject tokens, served
    on the inject path with no prefill; one user's delta plus its fresh
    events outgrows ``inject_len`` and falls back to a prefill."""
    rng = np.random.RandomState(4)
    events = (rng.randint(0, N_USERS, 200), rng.randint(0, N_ITEMS, 200),
              rng.randint(0, T0 - 100, 200))
    p = Pair(engines, pool=pool, events=events, delta_rewarm=True,
             rewarm_budget=8)
    users = [0, 1, 2, 3, 4, 5]
    p.submit_many(_reqs(users, T0))
    p.flush(T0)
    for u in (0, 1, 2):
        p.observe((u, 50 + u, 5 * DAY + 600 + u))
        p.observe((u, 80 + u, 5 * DAY + 700 + u))
        p.observe((u, 120 + u, 6 * DAY + 50 + u))
    for j in range(7):
        p.observe((0, 100 + j, 6 * DAY + 60 + j))
    p.tick(T0 + DAY)
    p.submit_many(_reqs(users, 6 * DAY + 100))
    p.flush(6 * DAY + 100)
    st = p.check()
    assert st.rollover.delta_rewarms == 3


@pytest.mark.parametrize("mode", ["sync", "background"])
def test_log_compaction(engines, mode, pool=False):
    """Tick-driven compaction of a windowed event log. A background
    compaction's worker is waited for after the tick that starts it (a
    join, not a sleep), so both gateways install it on the next tick."""
    p = Pair(engines, pool=pool, log_compaction=mode,
             store_kw=dict(log_window=DAY, log_retention_windows=3))
    for k in range(5):
        now = T0 + k * DAY // 2
        p.observe_many([1, 2], [3 + k, 4 + k], [now - 5] * 2)
        p.tick(now)
        for gw in p.gws:
            if gw._compactor is not None:
                gw._compactor.join(60)
        p.submit_many(_reqs([1, 2, 3], now))
        p.flush(now)
    st = p.check()
    assert st.ingest["compactions"] >= 2


# ----------------------------------------------------------------------
# Seeded schedules
# ----------------------------------------------------------------------

SCHEDULES = {
    0: {},
    1: {"max_wait": 0},
    2: {"rewarm_budget": 2, "cache_entries": 6},
    3: {"pane_service_time": 7, "shed_policy": "deadline"},
    4: {"snapshot_build_budget": 5, "warm_handoff": False},
    5: {"use_cache": False},
}


@pytest.mark.parametrize("seed", sorted(SCHEDULES))
def test_seeded_schedule(engines, seed, pool=False):
    """A seeded mix of single submits (random policy, slate length and
    deadline), waves, events, ticks and flushes, with the clock crossing
    daily boundaries."""
    p = Pair(engines, pool=pool, **SCHEDULES[seed])
    rng = np.random.RandomState(100 + seed)
    now = T0
    pols = [None, None, "batch", "inject", "fresh", "decay"]

    def spec(u):
        d = dict(user=int(u), now=now)
        if rng.rand() < 0.4:
            d["policy"] = pols[rng.randint(len(pols))]
        if rng.rand() < 0.3:
            d["slate_len"] = int(rng.randint(1, 6))
        if rng.rand() < 0.3:
            d["deadline"] = now + int(rng.randint(0, 40))
        return d

    for _ in range(40):
        op = rng.randint(6)
        if op == 0:
            p.submit(**spec(rng.randint(N_USERS)))
        elif op == 1:
            p.submit_many([spec(u) for u in
                           rng.randint(0, N_USERS, rng.randint(1, 9))])
        elif op == 2:
            n = rng.randint(1, 4)
            p.observe_many(rng.randint(0, N_USERS, n),
                           rng.randint(0, N_ITEMS, n),
                           now - rng.randint(0, 60, n))
        elif op == 3:
            now += int(rng.choice([1, 10, 60, DAY // 2]))
            p.tick(now)
        elif op == 4:
            p.flush(now)
        else:
            p.warm(rng.randint(0, N_USERS, 3), now)
    p.drain(now)
    st = p.check()
    assert st.requests + st.shed == len(p.tickets[1])


# ----------------------------------------------------------------------
# SSM caches through the host LRU, and aliasing
# ----------------------------------------------------------------------

def test_reduced_mamba2_through_the_lru(mamba_engines, pool=False):
    """reduced(mamba2-780m): conv tails and the f32 state are cached per
    row, reassembled and injected; a rollover rekeys them."""
    p = Pair(mamba_engines, pool=pool, rewarm_budget=4)
    users = [0, 1, 2, 3, 4, 5]
    p.warm(users, T0)
    p.observe_many([0, 1, 2], [7, 8, 9], [T0 - 5] * 3)
    p.submit_many(_reqs(users + [6], T0))
    p.flush(T0)
    p.observe_many([3], [10], [T0 + 600])
    p.tick(T0 + DAY)
    p.submit_many(_reqs(users, T0 + DAY + 5))
    p.flush(T0 + DAY + 5)
    st = p.check()
    assert st.paths["inject"] > 0 and st.rollover.rekeyed > 0


@pytest.mark.parametrize("arch", ["tiny-test", "mamba2"])
def test_cached_user_served_three_times_no_drift(engines, mamba_engines,
                                                 arch):
    """One cached user served three times on the inject path: inject and
    decode_slate write into their pane's state, never into the LRU entry,
    so the three slates and scores are equal and the entry is unchanged."""
    p = Pair(engines if arch == "tiny-test" else mamba_engines)
    p.warm([3, 4], T0)
    gw = p.gws[1]
    key = (3, gw._gen)
    before = {k: v.clone() for k, v in _flat(gw.cache._entries[key][0])}
    p.observe_many([3], [42], [T0 - 1])
    for k in range(3):
        p.submit_many(_reqs([3, 4, 3], T0 + k))
        p.flush(T0 + k)
    p.check()
    out = [t.response for t in p.tickets[1] if t.request.user == 3]
    assert [r.telemetry.path for r in out] == ["inject"] * 6
    for r in out[1:]:
        np.testing.assert_array_equal(r.slate, out[0].slate)
        np.testing.assert_array_equal(r.scores, out[0].scores)
    for k, v in _flat(gw.cache._entries[key][0]):
        assert torch.equal(v, before[k]), k


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


# ----------------------------------------------------------------------
# The paged state pool: every scenario again, pooled on both sides
# ----------------------------------------------------------------------

POOLED = {
    "waves_and_trickle": lambda e, m: test_waves_and_trickle(e, True),
    "max_wait_zero": lambda e, m: test_max_wait_zero_partial_panes(e, True),
    "mixed_policy": lambda e, m: test_mixed_policy_panes(e, True),
    "per_row_slate_len": lambda e, m: test_per_row_slate_len(e, True),
    "deadline_shedding": lambda e, m: test_deadline_flush_and_shedding(
        e, True),
    "eviction-entries": lambda e, m: test_lru_eviction(e, "entries", True),
    "eviction-bytes": lambda e, m: test_lru_eviction(e, "bytes", True),
    "handoff_rewarm": lambda e, m: test_warm_handoff_rollover_with_rewarm(
        e, True),
    "build_budget": lambda e, m: test_snapshot_build_budget(e, True),
    "background_build": lambda e, m: test_background_build(e, True),
    "delta_rewarm": lambda e, m: test_delta_rewarm(e, True),
    "compaction-sync": lambda e, m: test_log_compaction(e, "sync", True),
    "compaction-background": lambda e, m: test_log_compaction(
        e, "background", True),
    **{f"schedule-{k}": (lambda e, m, k=k: test_seeded_schedule(e, k, True))
       for k in sorted(SCHEDULES)},
    "reduced_mamba2": lambda e, m: test_reduced_mamba2_through_the_lru(
        m, True),
}


@pytest.mark.parametrize("case", list(POOLED))
def test_pooled_backend(engines, mamba_engines, case):
    """The scenario ``case`` with ``ServerConfig(pool_slots=...)`` on both
    Gateways, slots equal to the scenario's entry budget: the same
    responses and every non-wall-clock counter equal, the pool's
    ``slots``, ``free_slots``, ``slot_bytes`` and ``bytes_per_shard``
    included."""
    POOLED[case](engines, mamba_engines)


_OPS = ("submit", "observe", "tick", "flush")


def _random_ops(rng):
    """test_property.py's op language, drawn from a seeded RNG."""
    ops = []
    for _ in range(rng.randint(2, 15)):
        kind = _OPS[rng.randint(4)]
        if kind == "submit":
            dl = [None, 0, 1, 2, 5][rng.randint(5)]
            ops.append((kind, int(rng.randint(N_USERS)), dl))
        elif kind == "observe":
            ops.append((kind, int(rng.randint(N_USERS)),
                        int(rng.randint(N_ITEMS))))
        elif kind == "tick":
            ops.append((kind, int(rng.randint(1, 4))))
        else:
            ops.append((kind,))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_random_interleaving_pooled_continuous_equals_wave(engines, seed):
    """test_property.py's property on seeded schedules: interleaved
    submit/observe/tick/flush ops (deadlines down to ``now``) with a
    generation rollover between two halves, served by a pooled +
    continuous + shedding Gateway of each package (held against each
    other by ``Pair``, ``RolloverStats`` included) and by the port's
    host-LRU wave path (submit + flush at the same clock): every request
    the shedder admits is bit for bit the wave path's, and the shed ones
    are exactly the difference."""
    rng = np.random.RandomState(200 + seed)
    cont = Pair(engines, pool_slots=16, max_wait=0, pane_service_time=1,
                shed_policy="deadline")
    wave = Gateway(engines[1], make_injector("repro_torch"),
                   ServerConfig(slate_len=3, cache_entries=64))
    now = T0
    pairs = []

    def play(ops):
        nonlocal now
        for op in ops:
            if op[0] == "submit":
                _, user, dl = op
                spec = dict(user=user, now=now,
                            deadline=None if dl is None else now + dl)
                cont.submit(**spec)   # served-or-shed on arrival
                b = wave.submit(api.Request(**spec))
                wave.flush(now)
                a = cont.tickets[1][-1]
                assert a.done and b.done
                pairs.append((a, b))
            elif op[0] == "observe":
                cont.observe((op[1], op[2], now))
                wave.observe((op[1], op[2], now))
            elif op[0] == "tick":
                now += op[1]
                cont.tick(now)
                wave.tick(now)
            else:
                cont.flush(now)
                wave.flush(now)

    play(_random_ops(rng))
    now += DAY                          # mid-trace generation rollover
    cont.tick(now)
    wave.tick(now)
    play(_random_ops(rng))
    cont.drain(now)
    wave.drain(now)
    shed = 0
    for a, b in pairs:
        assert not b.response.shed
        if a.response.shed:
            shed += 1
            assert a.response.telemetry.path == "shed"
            assert a.response.slate.size == 0
            continue
        np.testing.assert_array_equal(a.response.slate, b.response.slate)
        np.testing.assert_array_equal(a.response.scores, b.response.scores)
        assert a.response.telemetry.policy == b.response.telemetry.policy
    st = cont.check()                   # JAX against port, rollover too
    assert st.shed == shed
