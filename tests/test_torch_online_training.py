"""The port's online trainer, weight patches and hot swap against the JAX
package's, on the CPU (``device="cpu"``) at the ``tiny-test`` width, fp32
with TF32 off.

* ``flatten_with_keystr``: the same ``keystr`` paths in the same order as
  ``jax.tree_util.tree_flatten_with_path``, with the same shapes, for
  ``tiny-test``, ``reduced(mamba2-780m)`` and ``itfi-ranker``.
* ``_build_batch``: bit-equal to the JAX trainer's from the same
  ``EventLog`` contents, round-robin cursor included.
* Trainer steps: metrics, weights and patches within 1e-5 of the JAX
  trainer's over the same events (AdamW ``eps`` 1e-3, as
  ``tests/test_torch_training.py`` explains); leaves outside
  ``trainable`` stay bit for bit.
* ``WeightPatch.to_bytes``: the same bytes as the JAX package's for the
  same leaves, bf16 included, and each package reads the other's.
* ``apply_patch``: the JAX engine's ``KeyError``/``ValueError`` messages,
  and nothing written when any leaf of a patch is bad.
* The hot swap: after ``install_patch`` a Gateway serves bit for bit what
  a cold Gateway built from the patched weights serves, from the host LRU
  and from the pool; a patch from either package installed in the other
  package's Gateway serves that package's slates (equal) and scores
  (within 1e-5); ``patch_policy="rewarm"``, the snapshot roll composed
  with the model version, and the background worker, joined and waited
  on through an event, never a sleep.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DAY, N_ITEMS, tiny_model_config
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.event_log import EventLog as JaxEventLog
from repro.models.model import init_params as jax_init_params
from repro.serving import api as jax_api
from repro.serving.engine import ServingConfig as JaxServingConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.scheduler import Gateway as JaxGateway
from repro.serving.scheduler import ServerConfig as JaxServerConfig
from repro.training import online as jax_online
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.train_loop import TrainConfig as JaxTrainConfig
from repro_torch.configs import get_config
from repro_torch.core.event_log import EventLog
from repro_torch.models.model import init_params
from repro_torch.serving import (Gateway, ServerConfig, ServingConfig,
                                 ServingEngine, api)
from repro_torch.training import (AdamWConfig, OnlineTrainer,
                                  OnlineTrainerConfig, TrainConfig,
                                  WeightPatch)
from repro_torch.training.online import flatten_with_keystr
from torch_port import make_injector, port_cfg, port_engine

TOL = dict(atol=1e-5, rtol=1e-5)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
T1 = 5 * DAY + 100
ADAMW = dict(lr=3e-2, warmup_steps=2, total_steps=1000, eps=1e-3)


def _jax_engine():
    """A private JAX engine (patches write into an engine; the shared
    ``tiny_engine`` stays untouched) on the conftest serving shape."""
    params = jax_init_params(tiny_model_config(), jax.random.PRNGKey(0),
                             dtype=jnp.float32)
    return JaxServingEngine(tiny_model_config(), params, JaxServingConfig(
        max_batch=4, prefill_len=32, inject_len=8, cache_capacity=64))


def _trainers(**cfg_kw):
    """A JAX trainer and the port's, from the same weights, over event logs
    of their own package (fed the same events by the test)."""
    jeng = _jax_engine()
    eng = port_engine(jeng)
    jlog, log = JaxEventLog(n_users=8), EventLog(n_users=8)
    cfg_kw.setdefault("batch_size", 4)
    cfg_kw.setdefault("seq_len", 8)
    jtr = jax_online.OnlineTrainer(
        jeng.cfg, jeng.params, jlog,
        cfg=jax_online.OnlineTrainerConfig(**cfg_kw),
        train_cfg=JaxTrainConfig(adamw=JaxAdamWConfig(**ADAMW), remat=False,
                                 param_dtype=jnp.float32))
    tr = OnlineTrainer(eng.cfg, eng.params, log,
                       cfg=OnlineTrainerConfig(**cfg_kw),
                       train_cfg=TrainConfig(adamw=AdamWConfig(**ADAMW),
                                             remat=False,
                                             param_dtype=torch.float32),
                       device="cpu")
    return (jlog, jtr), (log, tr)


def _append(logs, rng, n, t0):
    users = rng.randint(0, 8, n)
    items = rng.randint(0, N_ITEMS, n)
    for k in range(n):
        for log in logs:
            log.append(int(users[k]), int(items[k]), t0 + k)


def _close_leaves(got, want):
    """Two ``{keystr path: leaf}`` dicts, leaf by leaf within ``TOL``."""
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), **TOL)


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ----------------------------------------------------------------------
# Leaf paths, batches, steps
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tiny-test", "mamba2", "itfi-ranker"])
def test_flatten_with_keystr_matches_jax(arch):
    if arch == "tiny-test":
        jcfg = tiny_model_config()
    elif arch == "mamba2":
        jcfg = jax_reduced(jax_get_config("mamba2-780m"))
    else:
        jcfg = jax_get_config("itfi-ranker")
    cfg = get_config(arch) if arch == "itfi-ranker" else port_cfg(jcfg)
    shapes = jax.eval_shape(
        lambda k: jax_init_params(jcfg, k, jnp.float32),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = [(jax.tree_util.keystr(p), tuple(v.shape))
            for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [(k, tuple(v.shape)) for k, v in flatten_with_keystr(
        init_params(cfg, torch.Generator(), torch.float32, "meta"))]
    assert got == want


def test_build_batch_bit_equal():
    """Three batches from the same events, the round-robin cursor moving
    through more touched users than ``batch_size``."""
    (jlog, jtr), (log, tr) = _trainers(batch_size=3, seq_len=6)
    _append((jlog, log), np.random.RandomState(0), 60, 1000)
    for _ in range(3):
        jview, view = jlog.view(), log.view()
        ju, _, jts = jview.events_since(0)
        u, _, ts = view.events_since(0)
        want = jtr._build_batch(jview, ju, jts)
        got = tr._build_batch(view, u, ts)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert tr._rr == jtr._rr == 9


@pytest.mark.parametrize("trainable", [None, ("embed",)])
def test_trainer_steps_match_jax(trainable):
    (jlog, jtr), (log, tr) = _trainers(trainable=trainable)
    rng = np.random.RandomState(1)
    before = {k: v.clone() for k, v in flatten_with_keystr(tr.params)}
    for i in range(3):
        _append((jlog, log), rng, 24, 1000 + 100 * i)
        jm, m = jtr.step(), tr.step()
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], **TOL)
        assert (tr.steps, tr.cursor) == (jtr.steps, jtr.cursor)
    _close_leaves(dict(flatten_with_keystr(tr.params)),
                  _jax_leaves(jtr.params))
    for k, v in flatten_with_keystr(tr.params):
        if trainable is not None and "embed" not in k:
            assert torch.equal(v, before[k]), k     # frozen by construction
    jp, p = jtr.make_patch(), tr.make_patch()
    assert (p.version, p.base_version, p.step) == (jp.version,
                                                   jp.base_version, jp.step)
    assert p.metadata == jp.metadata and list(p.leaves) == list(jp.leaves)
    _close_leaves(p.leaves, jp.leaves)
    for v in p.leaves.values():
        assert v.device.type == "cpu"
    if trainable is not None:
        assert all("embed" in k for k in p.leaves)
        with pytest.raises(ValueError, match="matches no param leaf"):
            OnlineTrainer(tr.model_cfg, tr.params, log, device="cpu",
                          cfg=OnlineTrainerConfig(trainable=("nope",)))


def test_trainer_holds_its_own_tensors():
    """The trainer copies the weights it is given, and a step never
    writes into a tree it handed out."""
    (_, _), (log, tr) = _trainers()
    eng = port_engine(_jax_engine())
    tr2 = OnlineTrainer(eng.cfg, eng.params, log, device="cpu",
                        train_cfg=TrainConfig(adamw=AdamWConfig(**ADAMW),
                                              remat=False,
                                              param_dtype=torch.float32))
    ptrs = {v.data_ptr() for _, v in flatten_with_keystr(eng.params)}
    assert not ptrs & {v.data_ptr() for _, v in flatten_with_keystr(
        tr2.params)}
    handed = {k: (v, v.clone()) for k, v in flatten_with_keystr(tr2.params)}
    _append((log,), np.random.RandomState(2), 24, 1000)
    assert tr2.step() is not None
    for k, (v, copy) in handed.items():
        assert torch.equal(v, copy), k


def test_trainer_cursor_and_missed_events():
    """The JAX trainer's ``min_new_events`` gate and cursor, and the
    tiered log's ``missed_events`` accounting, on the port's log."""
    log = EventLog(8, window=100, retention_windows=1)
    eng = port_engine(_jax_engine())
    tr = OnlineTrainer(eng.cfg, eng.params, log, device="cpu",
                       cfg=OnlineTrainerConfig(batch_size=8, seq_len=16,
                                               min_new_events=8,
                                               window=10_000),
                       train_cfg=TrainConfig(adamw=AdamWConfig(**ADAMW),
                                             remat=False,
                                             param_dtype=torch.float32))
    assert tr.step() is None and tr.cursor == 0
    for i in range(16):
        log.append(i % 8, i % 8, 10 * i)
    log.compact(1000, keep_from=tr.cursor)       # pins everything
    assert log.ingest_stats()["evicted"] == 0
    assert tr.step() is not None
    assert tr.missed_events == 0 and tr.cursor == 16
    for i in range(16):
        log.append(i % 8, i % 8, 1000 + 10 * i)
    log.compact(2400)
    assert log.ingest_stats()["evicted"] == 32
    tr.step()
    assert tr.missed_events == 16 and tr.cursor == 32


# ----------------------------------------------------------------------
# The wire format and apply_patch
# ----------------------------------------------------------------------

def _leaves_pair():
    f32 = (np.arange(12, dtype=np.float32) * 0.1).reshape(3, 4)
    bf = (jnp.arange(5, dtype=jnp.float32) * 0.3).astype(jnp.bfloat16)
    jleaves = {"['a']['w']": f32, "['b']": bf,
               "['c']": np.arange(4, dtype=np.int32)}
    tleaves = {"['a']['w']": torch.from_numpy(f32.copy()),
               "['b']": torch.from_numpy(np.asarray(bf).view(np.int16)
                                         .copy()).view(torch.bfloat16),
               "['c']": torch.arange(4, dtype=torch.int32)}
    return jleaves, tleaves


def test_weight_patch_bytes_cross_packages():
    jleaves, tleaves = _leaves_pair()
    meta = {"note": "x", "steps": 17}
    jp = jax_online.WeightPatch(3, 2, 17, jleaves, meta)
    tp = WeightPatch(3, 2, 17, tleaves, meta)
    assert tp.n_leaves == jp.n_leaves and tp.n_params == jp.n_params
    jb, tb = jp.to_bytes(), tp.to_bytes()
    assert tb == jb
    back = WeightPatch.from_bytes(jb)
    assert (back.version, back.base_version, back.step) == (3, 2, 17)
    assert back.metadata == meta and back.to_bytes() == jb
    assert back.leaves["['b']"].dtype == torch.bfloat16
    assert torch.equal(back.leaves["['b']"].view(torch.int16),
                       tleaves["['b']"].view(torch.int16))
    assert jax_online.WeightPatch.from_bytes(tb).to_bytes() == tb
    with pytest.raises(ValueError):
        WeightPatch.from_bytes(b"\x00junk" * 5)
    doc = jp.to_bytes().replace(b"\xa5codec\x01", b"\xa5codec\x02")
    with pytest.raises(ValueError, match="codec"):
        WeightPatch.from_bytes(doc)


def test_trainer_patch_bytes_cross_packages():
    """A real patch from each package's trainer reads back in the other
    and writes the same bytes again."""
    (jlog, jtr), (log, tr) = _trainers(trainable=("embed",))
    _append((jlog, log), np.random.RandomState(3), 24, 1000)
    jtr.step()
    tr.step()
    jb, tb = jtr.make_patch().to_bytes(), tr.make_patch().to_bytes()
    assert WeightPatch.from_bytes(jb).to_bytes() == jb
    assert jax_online.WeightPatch.from_bytes(tb).to_bytes() == tb


def _raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def test_apply_patch_validation_matches_jax():
    jeng = _jax_engine()
    eng = port_engine(jeng)
    key, leaf = flatten_with_keystr(eng.params)[0]
    bad = [{"['nope']": np.zeros(3, np.float32)},
           {key: np.zeros(tuple(s + 1 for s in leaf.shape), np.float32)},
           {key: np.zeros(tuple(leaf.shape), np.float16)}]
    for patch in bad:
        got = _raised(lambda: eng.apply_patch(patch))
        assert got == _raised(lambda: jeng.apply_patch(patch))
    assert [_raised(lambda: eng.apply_patch(p))[0] for p in bad] == \
        ["KeyError", "ValueError", "ValueError"]
    assert eng.apply_patch({}) == 0
    # a bad leaf anywhere in the patch: nothing is written
    before = {k: v.clone() for k, v in flatten_with_keystr(eng.params)}
    good = np.asarray(leaf) + 1.0
    with pytest.raises(ValueError):
        eng.apply_patch({key: good, **bad[1]})
    for k, v in flatten_with_keystr(eng.params):
        assert torch.equal(v, before[k]), k
    # a good patch is copied in place, and the caller's value stays theirs
    new = torch.from_numpy(good.copy())
    assert eng.apply_patch({key: new}) == 1
    got = dict(flatten_with_keystr(eng.params))[key]
    assert got.data_ptr() == leaf.data_ptr() and torch.equal(got, new)
    new += 5.0
    assert not torch.equal(got, new)


# ----------------------------------------------------------------------
# The hot swap
# ----------------------------------------------------------------------

BACKENDS = {"host_lru": {}, "pooled": {"pool_slots": 8}}


def _engine_with(params):
    """A cold port engine from ``params`` on the conftest serving shape."""
    return ServingEngine(port_cfg(tiny_model_config()), params,
                         ServingConfig(max_batch=4, prefill_len=32,
                                       inject_len=8, cache_capacity=64),
                         device="cpu")


def _gateway(engine, **kw):
    kw.setdefault("slate_len", 3)
    kw.setdefault("cache_entries", 64)
    return Gateway(engine, make_injector("repro_torch"), ServerConfig(**kw))


def _jax_gateway(engine, **kw):
    kw.setdefault("slate_len", 3)
    kw.setdefault("cache_entries", 64)
    return JaxGateway(engine, make_injector("repro"), JaxServerConfig(**kw))


def _trainer(gw, **cfg_kw):
    return OnlineTrainer(gw.engine.cfg, gw.engine.params,
                         gw.injector.batch.log,
                         cfg=OnlineTrainerConfig(**cfg_kw),
                         train_cfg=TrainConfig(adamw=AdamWConfig(**ADAMW),
                                               remat=False,
                                               param_dtype=torch.float32),
                         device="cpu")


def _serve(gw, users, now, mod=api):
    tk = [gw.submit(mod.Request(user=int(u), now=int(now))) for u in users]
    gw.flush(now)
    return tk


def _slates(tickets):
    return (np.stack([t.response.slate for t in tickets]),
            np.stack([t.response.scores for t in tickets]))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_hot_swap_bitwise_vs_cold_gateway(backend):
    """After ``install_patch`` the Gateway serves bit for bit what a cold
    Gateway built from the patched weights serves; no entry of the old
    version is reachable."""
    kw = BACKENDS[backend]
    gw = _gateway(port_engine(_jax_engine()), **kw)
    users = [0, 1, 2, 3, 4, 5]
    _serve(gw, users, T1)                     # warm the old-version cache
    gw.poll()
    tr = _trainer(gw)
    for _ in range(3):
        tr.step()
    assert tr.steps >= 1
    patch = tr.make_patch()
    assert (patch.version, patch.base_version) == (1, 0)
    assert gw.install_patch(patch) == patch.n_leaves
    tk = _serve(gw, users, T1 + 300)
    assert all(t.response.telemetry.model_version == 1 for t in tk)
    st = gw.stats()
    assert st.model_version == 1 and st.patches_applied == 1
    assert st.patch_install_max_ms > 0.0
    assert all(g[1] == 1 for (_, g) in gw.cache._entries)
    cold = _gateway(_engine_with(tr.params), **kw)
    ck = _serve(cold, users, T1 + 300)
    for a, b in zip(_slates(tk), _slates(ck)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("source", ["jax", "port"])
def test_patch_crosses_packages_and_serves_the_same(source):
    """A trainer's patch from one package, through its bytes, into both
    packages' Gateways (warm, on equal weights and feature planes): the
    same slates, scores within 1e-5, model version 1 on both."""
    jgw = _jax_gateway(_jax_engine())
    gw = _gateway(port_engine(_jax_engine()))
    users = [0, 1, 2, 3, 4, 5]
    _serve(jgw, users, T1, jax_api)
    _serve(gw, users, T1)
    if source == "jax":
        jtr = jax_online.OnlineTrainer(
            jgw.engine.cfg, jgw.engine.params, jgw.injector.batch.log,
            train_cfg=JaxTrainConfig(adamw=JaxAdamWConfig(**ADAMW),
                                     remat=False, param_dtype=jnp.float32))
        jtr.step()
        blob = jtr.make_patch().to_bytes()
    else:
        tr = _trainer(gw)
        tr.step()
        blob = tr.make_patch().to_bytes()
    jgw.install_patch(jax_online.WeightPatch.from_bytes(blob))
    gw.install_patch(WeightPatch.from_bytes(blob))
    jt = _serve(jgw, users, T1 + 300, jax_api)
    tt = _serve(gw, users, T1 + 300)
    np.testing.assert_array_equal(_slates(tt)[0], _slates(jt)[0])
    np.testing.assert_allclose(_slates(tt)[1], _slates(jt)[1], **TOL)
    assert [t.response.telemetry.model_version for t in tt] == [1] * 6
    assert gw.stats().model_version == jgw.stats().model_version == 1


def test_patch_policy_rewarm_rebuilds_under_new_version():
    gw = _gateway(port_engine(_jax_engine()), patch_policy="rewarm",
                  rewarm_budget=8)
    users = [0, 1, 2, 3]
    _serve(gw, users, T1)
    tr = _trainer(gw)
    tr.step()
    gw.install_patch(tr.make_patch())
    assert gw.stats().rollover.pending_rewarm == len(users)
    pc0 = gw.prefill_calls
    gw.tick(T1 + 60)                          # budgeted re-warm
    assert gw.stats().rollover.pending_rewarm == 0
    assert gw.prefill_calls > pc0
    assert all(g[1] == 1 for (_, g) in gw.cache._entries)
    h0 = gw.cache.hits
    tk = _serve(gw, users, T1 + 120)
    assert gw.cache.hits - h0 == len(users)
    cold = _gateway(_engine_with(tr.params))
    ck = _serve(cold, users, T1 + 120)
    for a, b in zip(_slates(tk), _slates(ck)):
        np.testing.assert_array_equal(a, b)


def test_snapshot_rollover_composes_with_model_version():
    gw = _gateway(port_engine(_jax_engine()), rewarm_budget=4)
    users = [0, 1, 2, 3]
    _serve(gw, users, T1)
    tr = _trainer(gw)
    tr.step()
    gw.install_patch(tr.make_patch())
    _serve(gw, users, T1 + 60)                # re-admit under (gen_a, 1)
    gw.tick(T1 + DAY)                         # the snapshot rolls
    gen_b = gw.injector.generation(T1 + DAY)
    st = gw.stats()
    assert st.model_version == 1 and st.rollover.rollovers >= 1
    tk = _serve(gw, users, T1 + DAY + 60)
    assert all(t.response.telemetry.generation == gen_b
               and t.response.telemetry.model_version == 1 for t in tk)
    assert all(g == (gen_b, 1) for (_, g) in gw.cache._entries)


def test_background_worker_installs_between_panes():
    """``attach_trainer(trainer.start())``: the worker trains off the
    serving thread and queues a patch; the test waits for it on an event
    (no sleep), joins the worker, and the next ``tick`` installs every
    queued patch; each response then carries the one served version."""
    gw = _gateway(port_engine(_jax_engine()))
    _serve(gw, [0, 1], T1)
    queued = threading.Event()
    tr = _trainer(gw, steps_per_patch=1, interval_s=0.01)
    tr._step_hook = lambda: queued.set() if tr.version >= 1 else None
    gw.attach_trainer(tr)
    tr.start()
    try:
        assert queued.wait(timeout=120), "the worker queued no patch"
    finally:
        tr.stop(timeout=120)
    assert not tr._thread.is_alive()
    gw.tick(T1 + 60)
    st = gw.stats()
    assert st.patches_applied == tr.version >= 1
    assert st.model_version == st.patches_applied
    tk = _serve(gw, [0, 1, 2], T1 + 120)
    assert {t.response.telemetry.model_version for t in tk} == \
        {st.model_version}
    tr2 = _trainer(gw)
    for _ in range(st.model_version + 1):     # one past the served version
        tr2.make_patch()
    with pytest.raises(ValueError, match="base-version guard"):
        gw.attach_trainer(tr2)
