"""The port's paged device state pool (``serving/pool.py``), on the CPU.

Mirrors ``tests/test_state_pool.py`` at ``tiny-test`` and the reduced
Mamba2, and holds the port against the JAX package where it has a
counterpart:

1. **Pool mechanics** — gather and scatter round-trip every state leaf
   bit for bit (f32 K/V, the SSM conv tails and f32 state, bool
   ``valid``, int32 ``next_pos``), untouched slots stay untouched, a slot
   can be overwritten, short panes pad by repeating the first slot, a
   gathered pane shares no storage with the pool, and the JAX package's
   ``ValueError`` messages are kept. ``prefill_state_shapes()`` gives the
   JAX method's shapes and dtypes, and a real ``max_batch`` prefill's.
2. **Slot table** — 300 seeded operations leave the port's
   ``PagedStateCache`` and the JAX one with the same return values, the
   same LRU order, free list, pending tokens and ``stats()``.
3. **Serving equivalence** — the pooled port Gateway is bitwise equal to
   the host-LRU port Gateway across slot-pressure eviction and a
   rollover; a ``max_wait=0`` trickle equals the wave path for every
   policy wave; one cached user served three times leaves its slot as it
   was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DAY, N_ITEMS, N_USERS, tiny_engine
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models.model import init_params as jax_init_params
from repro.serving import pool as jax_pool
from repro.serving.engine import ServingConfig as JaxServingConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.serving import (DeviceStatePool, Gateway, PagedStateCache,
                                 Request, ServerConfig)
from torch_port import make_injector, port_engine

T0 = 5 * DAY + 100


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) by arch: ``tiny-test`` and the reduced
    Mamba2, at ``max_batch`` 4, ``prefill_len`` 32, ``inject_len`` 8."""
    jtiny = tiny_engine()
    jcfg = jax_reduced(jax_get_config("mamba2-780m"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jmamba = JaxServingEngine(jcfg, jparams, JaxServingConfig(
        max_batch=4, prefill_len=32, inject_len=8, cache_capacity=64))
    return {"tiny-test": (jtiny, port_engine(jtiny)),
            "mamba2": (jmamba, port_engine(jmamba))}


ARCHS = ["tiny-test", "mamba2"]


def _prefill_pane(engine, seed=0):
    """A real prefill state for max_batch rows of random histories."""
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(1, N_ITEMS, rng.randint(4, 20)).tolist()
            for _ in range(engine.scfg.max_batch)]
    toks, valid = engine.pad_tokens(seqs, engine.scfg.prefill_len)
    return engine.prefill(toks, valid)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_rows_equal(gathered, last, state, rows):
    """Row ``i`` of the gathered pane == row ``rows[i]`` of ``state``,
    bit for bit, for every leaf (bool valid and int32 next_pos too)."""
    idx = torch.as_tensor(rows)
    want = dict(_flat(state["caches"]))
    for name, g in _flat(gathered["caches"]):
        assert g.dtype == want[name].dtype, name
        assert torch.equal(g, want[name][:, idx]), name
    assert gathered["valid"].dtype == torch.bool
    assert gathered["next_pos"].dtype == torch.int32
    assert torch.equal(gathered["valid"], state["valid"][idx])
    assert torch.equal(gathered["next_pos"], state["next_pos"][idx])
    assert gathered["logits"] is None
    assert torch.equal(last, state["logits"][idx, -1, :])


# ----------------------------------------------------------------------
# 1. Pool mechanics
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_pool_roundtrip_bitwise(engines, arch):
    eng = engines[arch][1]
    pool = DeviceStatePool(eng, 8)
    state = _prefill_pane(eng)
    names = [n for n, _ in _flat(state["caches"])]
    if arch == "mamba2":  # the SSM leaves: conv tails and the f32 state
        assert any(n.endswith("state") for n in names), names
        assert dict(_flat(pool.caches))[names[-1]].dtype == torch.float32
    pool.scatter(state, [5, 0, 7, 2])
    gathered, last = pool.gather([5, 0, 7, 2])
    _assert_rows_equal(gathered, last, state, [0, 1, 2, 3])
    assert pool.gathers == 1 and pool.scatters == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_pool_scatter_leaves_other_slots_untouched(engines, arch):
    eng = engines[arch][1]
    pool = DeviceStatePool(eng, 8)
    a, b = _prefill_pane(eng, seed=1), _prefill_pane(eng, seed=2)
    pool.scatter(a, [0, 1, 2, 3])
    pool.scatter(b, [4, 5])          # short writeback: pane rows 0, 1 only
    ga, la = pool.gather([0, 1, 2, 3])
    _assert_rows_equal(ga, la, a, [0, 1, 2, 3])        # a intact
    gb, lb = pool.gather([4, 5])                       # padded assembly
    _assert_rows_equal(gb, lb, b, [0, 1, 0, 0])
    untouched = [6, 7]
    for _, x in _flat(pool.caches):
        assert not x[:, untouched].any()
    assert not pool.valid[untouched].any()
    assert not pool.next_pos[untouched].any()


def test_pool_overwrite_slot(engines):
    eng = engines["tiny-test"][1]
    pool = DeviceStatePool(eng, 4)
    a, b = _prefill_pane(eng, seed=1), _prefill_pane(eng, seed=2)
    pool.scatter(a, [0, 1, 2, 3])
    pool.scatter(b, [1])             # overwrite one slot in place
    g, last = pool.gather([0, 1, 2, 3])
    for name, x in _flat(g["caches"]):
        assert torch.equal(x[:, [0, 2, 3]],
                           dict(_flat(a["caches"]))[name][:, [0, 2, 3]])
        assert torch.equal(x[:, 1], dict(_flat(b["caches"]))[name][:, 0])
    assert torch.equal(last[1], b["logits"][0, -1])
    assert torch.equal(last[0], a["logits"][0, -1])


def test_gather_returns_new_tensors(engines):
    """A gathered pane shares no storage with the pool: inject and
    decode_slate may write into it and the slots stay as they were."""
    eng = engines["mamba2"][1]
    pool = DeviceStatePool(eng, 4)
    pool.scatter(_prefill_pane(eng), [0, 1, 2, 3])
    before = {n: x.clone() for n, x in _flat(pool.caches)}
    g, last = pool.gather([2, 0])
    for _, x in _flat(g["caches"]):
        x.add_(1)
    g["valid"].logical_not_()
    g["next_pos"].add_(1)
    last.add_(1)
    for n, x in _flat(pool.caches):
        assert torch.equal(x, before[n]), n
    g2, last2 = pool.gather([2, 0])
    assert not torch.equal(g2["valid"], g["valid"])
    assert not torch.equal(last2, last)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_pool_value_errors_match_jax(engines):
    jeng, eng = engines["tiny-test"]
    assert _message(lambda: DeviceStatePool(eng, 2)) == \
        _message(lambda: jax_pool.DeviceStatePool(jeng, 2))
    assert "pool_slots" in _message(lambda: DeviceStatePool(eng, 3))
    with pytest.raises(ValueError, match="pool_slots"):
        Gateway(eng, make_injector("repro_torch"), ServerConfig(pool_slots=2))
    pool, jpool = DeviceStatePool(eng, 4), jax_pool.DeviceStatePool(jeng, 4)
    for call in (lambda p: p.gather([]),
                 lambda p: p.gather([0, 1, 2, 3, 0])):
        assert _message(lambda: call(pool)) == _message(lambda: call(jpool))
    state = _prefill_pane(eng)
    assert _message(lambda: pool.scatter(state, [0, 1, 2, 3, 0])) == \
        _message(lambda: jpool.scatter(_prefill_pane(jeng), [0, 1, 2, 3, 0]))
    assert pool.gathers == pool.scatters == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_state_shapes_match_jax(engines, arch):
    """The JAX method's shapes and dtype names, a real max_batch prefill's
    leaves, and the same bytes a slot."""
    jeng, eng = engines[arch]
    jlogits, jcaches = jeng.prefill_state_shapes()
    logits, caches = eng.prefill_state_shapes()
    assert tuple(logits.shape) == tuple(jlogits.shape)
    assert str(logits.dtype) == f"torch.{jlogits.dtype}"
    jflat = {jax.tree_util.keystr(p): x for p, x in
             jax.tree_util.tree_flatten_with_path(jcaches)[0]}
    flat = dict(_flat(caches))
    assert len(flat) == len(jflat)
    for name, s in flat.items():
        j = jflat["".join(f"['{k}']" for k in name.split("/"))]
        assert tuple(s.shape) == tuple(j.shape), name
        assert str(s.dtype) == f"torch.{j.dtype}", name
    real = _prefill_pane(eng)
    assert tuple(real["logits"].shape) == tuple(logits.shape)
    assert real["logits"].dtype == logits.dtype
    for name, x in _flat(real["caches"]):
        assert (tuple(x.shape), x.dtype) == (flat[name].shape,
                                             flat[name].dtype), name
    assert DeviceStatePool(eng, 4).slot_nbytes == \
        jax_pool.DeviceStatePool(jeng, 4).slot_nbytes


# ----------------------------------------------------------------------
# 2. Slot table (PagedStateCache) against the JAX one
# ----------------------------------------------------------------------

class StubPool:
    """What the slot table reads of its pool."""

    def __init__(self, n_slots):
        self.n_slots, self.slot_nbytes, self.data_shards = n_slots, 1234, 1


def _call(obj, name, *args):
    try:
        return getattr(obj, name)(*args)
    except (KeyError, RuntimeError) as e:
        return ("raised", type(e).__name__, str(e))


def test_slot_table_matches_jax_over_seeded_ops():
    port = PagedStateCache(StubPool(6))
    ref = jax_pool.PagedStateCache(StubPool(6))
    rng = np.random.RandomState(11)
    gens = [100, 200, 300]
    scratch = []
    raised = set()
    ops = ["lookup", "admit", "alloc_scratch", "free_scratch",
           "invalidate_except", "rekey_generation", "rekey_entry", "drop",
           "has_entry", "set_pending", "get_pending"]
    odds = np.array([4, 8, 1, 1, .5, 2, 1.5, 1, 1, 2, 1])
    for step in range(300):
        op = ops[rng.choice(len(ops), p=odds / odds.sum())]
        u, g = int(rng.randint(10)), gens[rng.randint(3)]
        g2 = gens[rng.randint(3)]
        pinned = {s for s in port._entries.values() if rng.rand() < 0.4}
        if rng.rand() < 0.03:
            pinned = set(range(6))          # every slot: no victim
        if op in ("admit", "alloc_scratch"):
            args = (op, u, g, pinned) if op == "admit" else (op, pinned)
        elif op == "free_scratch":
            if not scratch:
                continue
            args = (op, scratch.pop(rng.randint(len(scratch))))
        elif op == "invalidate_except":
            args = (op, g)
        elif op == "rekey_generation":
            changed = rng.randint(0, 10, rng.randint(0, 5))
            args = (op, g, g2, changed, bool(rng.rand() < .7))
        elif op == "rekey_entry":
            args = (op, u, g, g2)
        elif op == "set_pending":
            args = (op, u, g, rng.randint(0, 50, rng.randint(0, 4)).tolist())
        else:
            args = (op, u, g)
        got, want = _call(port, *args), _call(ref, *args)
        assert got == want, (step, args)
        if isinstance(got, tuple) and got[0] == "raised":
            raised.add(args[0])
        elif args[0] == "alloc_scratch":
            scratch.append(got)
        assert list(port._entries.items()) == list(ref._entries.items())
        assert list(port._free) == list(ref._free)
        assert port._pending == ref._pending
        assert port._handoff_stale == ref._handoff_stale
        assert port.stats() == ref.stats(), step
        assert len(port) == len(ref) and port.budget == ref.budget
        assert port.byte_budget == ref.byte_budget
    st = port.stats()
    assert st["evictions"] > 0 and st["rekeys"] > 0
    assert st["stale_evictions"] > 0 and st["invalidations"] > 0
    assert {"admit", "set_pending"} <= raised


# ----------------------------------------------------------------------
# 3. Serving equivalence on the port
# ----------------------------------------------------------------------

def _gateway(eng, pool_slots=None, max_wait=None, cache_entries=64):
    return Gateway(eng, make_injector("repro_torch"), ServerConfig(
        slate_len=3, cache_entries=cache_entries, pool_slots=pool_slots,
        max_wait=max_wait))


def _wave(gw, reqs, now):
    tickets = gw.submit_many(list(reqs))
    gw.flush(now)
    assert all(t.done for t in tickets)
    return tickets


def _ingest(gws, users, items, ts):
    for gw in gws:
        gw.observe_many(users, items, ts)


def _assert_same(ta, tb):
    for a, b in zip(ta, tb):
        np.testing.assert_array_equal(a.response.slate, b.response.slate)
        np.testing.assert_array_equal(a.response.scores, b.response.scores)
        assert a.response.telemetry.path == b.response.telemetry.path


@pytest.mark.parametrize("arch", ARCHS)
def test_pooled_gateway_bitwise_equals_host_lru(engines, arch):
    """Same traffic through the pooled and host-LRU port Gateways: slates
    and scores bit for bit, the same hit/miss/eviction/rekey counters,
    across slot-pressure eviction AND a generation rollover."""
    eng = engines[arch][1]
    pooled = _gateway(eng, pool_slots=6)
    host = _gateway(eng, cache_entries=6)
    rng = np.random.RandomState(1)
    now = T0
    waves = [rng.randint(0, N_USERS, 9) for _ in range(3)]
    waves.append(waves[0])                       # revisit evicted users
    for users in waves:
        # fresh events for only HALF the wave: the quiet half stays
        # certifiably unchanged, so the rollover exercises rekey (warm
        # handoff) and invalidation side by side
        ev_users = users[: len(users) // 2]
        _ingest((pooled, host), ev_users,
                rng.randint(0, N_ITEMS, len(ev_users)),
                np.full(len(ev_users), now - 30))
        _assert_same(
            _wave(pooled, [Request(user=int(u), now=now) for u in users],
                  now),
            _wave(host, [Request(user=int(u), now=now) for u in users], now))
        now += 300
    now = 6 * DAY + 100                          # rollover wave
    users = waves[0]
    _assert_same(
        _wave(pooled, [Request(user=int(u), now=now) for u in users], now),
        _wave(host, [Request(user=int(u), now=now) for u in users], now))
    for k in ("hits", "misses", "evictions", "rekeys", "invalidations"):
        assert getattr(pooled.cache, k) == getattr(host.cache, k), k
    assert pooled.cache.evictions > 0 and pooled.cache.rekeys > 0
    assert pooled.pool.gathers > 0 and pooled.pool.scatters > 0
    wall_clock = ("build_time_s", "build_slice_max_s")
    rollover = [{k: v for k, v in vars(gw.stats().rollover).items()
                 if k not in wall_clock} for gw in (pooled, host)]
    assert rollover[0] == rollover[1]


_POLICY_WAVES = [
    [None, "batch", "inject", "fresh"],
    ["inject", "inject", "inject", "inject"],
    ["fresh", None, "batch", None],
]


@pytest.mark.parametrize("pooled", [False, True],
                         ids=["host-lru", "paged-pool"])
def test_continuous_trickle_bitwise_equals_wave(engines, pooled):
    """A trickle of single submits through the continuous scheduler
    (``max_wait=0``: every arrival served at once in a padded partial
    pane) gives responses bit for bit equal to the same requests batched
    through the wave path, for every policy wave, with and without the
    pool."""
    eng = engines["tiny-test"][1]
    slots = 16 if pooled else None
    wave = _gateway(eng, pool_slots=slots)
    trickle = _gateway(eng, pool_slots=slots, max_wait=0)
    rng = np.random.RandomState(2)
    now = T0
    for pols in _POLICY_WAVES:
        users = rng.randint(0, N_USERS, len(pols))
        _ingest((wave, trickle), users, rng.randint(0, N_ITEMS, len(pols)),
                np.full(len(pols), now - 30))
        wt = _wave(wave, [Request(user=int(u), now=now, policy=p)
                          for u, p in zip(users, pols)], now)
        tt = []
        for u, p in zip(users, pols):
            t = trickle.submit(Request(user=int(u), now=now, policy=p))
            assert t.done                        # served on arrival
            tt.append(t)
        assert len(trickle.poll()) == len(pols)  # streamed out exactly once
        for a, b in zip(wt, tt):
            assert a.response.telemetry.policy == b.response.telemetry.policy
        _assert_same(wt, tt)
        now += 300
    assert trickle.stats()["panes"] == sum(map(len, _POLICY_WAVES))
    if pooled:
        assert trickle.pool.scatters > 0 and trickle.stats().cache["slots"]


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_user_served_three_times_slot_unchanged(engines, arch):
    """One cached user served three times on the inject path: inject and
    decode_slate write into the gathered pane, never into the pool, so
    the three slates and scores are equal and the user's slot holds what
    warm scattered into it."""
    eng = engines[arch][1]
    gw = _gateway(eng, pool_slots=8)
    gw.warm([3, 4], T0)
    slot = gw.cache._entries[(3, gw._gen)]
    before = {n: x[:, slot].clone() for n, x in _flat(gw.pool.caches)}
    rest = (gw.pool.valid[slot].clone(), gw.pool.next_pos[slot].clone(),
            gw.pool.last_logits[slot].clone())
    scatters = gw.pool.scatters
    gw.observe_many([3], [42], [T0 - 1])
    out = []
    for k in range(3):
        tickets = _wave(gw, [Request(user=u, now=T0 + k) for u in (3, 4, 3)],
                        T0 + k)
        out += [t.response for t in tickets if t.request.user == 3]
    assert [r.telemetry.path for r in out] == ["inject"] * 6
    for r in out[1:]:
        np.testing.assert_array_equal(r.slate, out[0].slate)
        np.testing.assert_array_equal(r.scores, out[0].scores)
    assert gw.pool.scatters == scatters
    for n, x in _flat(gw.pool.caches):
        assert torch.equal(x[:, slot], before[n]), n
    assert torch.equal(gw.pool.valid[slot], rest[0])
    assert torch.equal(gw.pool.next_pos[slot], rest[1])
    assert torch.equal(gw.pool.last_logits[slot], rest[2])
