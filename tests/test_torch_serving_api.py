"""The port's request API (``serving/api.py``), ``ServerConfig``, the host
prefill-state cache, the deprecated ``InjectionServer`` shim and the
engine's ``logits_last_only``, against the JAX package where it has a
counterpart.

The API types must have the JAX package's fields and defaults, and every
validation must raise the same exception with the same message. A seeded
sequence of cache operations must leave both packages' ``PrefillStateCache``
with the same keys in the same LRU order and the same counters, bytes
included. The shim must warn and serve bit for bit what ``submit_many`` +
``flush`` serves. The weight-patch surface (``attach_trainer``,
``install_patch``) must refuse what the JAX Gateway refuses, with the same
messages.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import DAY, N_ITEMS, N_USERS, tiny_engine
from repro.serving import api as jax_api
from repro.serving import scheduler as jax_scheduler
from repro_torch.serving import api, scheduler
from repro_torch.serving.loop import InjectionServer, ServeResult
from repro_torch.serving.scheduler import (Gateway, PrefillStateCache,
                                           ServerConfig)
from torch_port import make_injector, port_engine

T0 = 5 * DAY + 100
TYPES = ["Event", "Request", "RequestTelemetry", "Response", "RolloverStats",
         "GatewayStats"]


@pytest.fixture(scope="module")
def engine():
    return port_engine(tiny_engine())


def _gateway(engine, policy="inject", **cfg_kw):
    cfg_kw.setdefault("slate_len", 3)
    cfg_kw.setdefault("cache_entries", 64)
    return Gateway(engine, make_injector("repro_torch", policy),
                   ServerConfig(**cfg_kw))


def _fields(cls):
    return [(f.name, f.default, f.compare) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", TYPES)
def test_api_types_match_field_for_field(name):
    assert _fields(getattr(api, name)) == _fields(getattr(jax_api, name))
    assert api.POLICIES == jax_api.POLICIES


def test_server_config_matches_field_for_field():
    assert _fields(ServerConfig) == _fields(jax_scheduler.ServerConfig)
    kw = dict(slate_len=7, cache_entries=9, cache_bytes=1000, max_wait=0,
              pane_service_time=3, shed_policy="deadline", rewarm_budget=2,
              delta_rewarm=True, log_compaction="sync")
    assert dataclasses.asdict(ServerConfig(**kw)) == dataclasses.asdict(
        jax_scheduler.ServerConfig(**kw))


def _raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


BAD_REQUESTS = [dict(user=-1, now=0), dict(user=1, now=0, policy="bogus"),
                dict(user=1, now=0, slate_len=0),
                dict(user=1, now=100, deadline=99)]
BAD_CONFIGS = [dict(slate_len=0), dict(cache_entries=0), dict(cache_bytes=0),
               dict(snapshot_build_budget=0), dict(rewarm_budget=-1),
               dict(pool_slots=0), dict(max_wait=-1),
               dict(pane_service_time=0), dict(shed_policy="eager"),
               dict(shed_policy="deadline"), dict(patch_policy="keep"),
               dict(log_compaction="eager")]


@pytest.mark.parametrize("kw", BAD_REQUESTS + BAD_CONFIGS,
                         ids=lambda kw: ",".join(map(str, kw.items())))
def test_validation_messages_match(kw):
    if "user" in kw:
        got = _raised(lambda: api.Request(**kw))
        want = _raised(lambda: jax_api.Request(**kw))
    else:
        got = _raised(lambda: ServerConfig(**kw))
        want = _raised(lambda: jax_scheduler.ServerConfig(**kw))
    assert got == want and got[0] == "ValueError"


def test_request_is_frozen_and_deadline_may_equal_now():
    r = api.Request(user=1, now=0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.user = 2
    assert api.Request(user=1, now=5, deadline=5).deadline == 5


def test_gateway_and_submit_validation_match(engine):
    """Construction and call-site errors: the same type and message as
    the JAX Gateway's, and a rejected request or event changes nothing."""
    jeng = tiny_engine()
    vocab = engine.cfg.vocab_size
    pairs = []
    for eng, mod, gw_cls, pkg in ((jeng, jax_api, jax_scheduler.Gateway,
                                   "repro"),
                                  (engine, api, Gateway, "repro_torch")):
        cfg_cls = (jax_scheduler.ServerConfig if pkg == "repro"
                   else ServerConfig)
        inj = make_injector(pkg)
        gw = gw_cls(eng, inj, cfg_cls(slate_len=3))
        bad_inj = make_injector(pkg)
        object.__setattr__(bad_inj.cfg, "policy", "bogus")
        out = [
            _raised(lambda: gw_cls(eng, inj, cfg_cls(slate_len=vocab + 1))),
            _raised(lambda: gw_cls(eng, bad_inj, cfg_cls())),
            _raised(lambda: gw.submit(mod.Request(user=1, now=0,
                                                  slate_len=vocab + 1))),
            _raised(lambda: gw.submit(mod.Request(user=N_USERS, now=0))),
            _raised(lambda: gw.submit_many([mod.Request(user=1, now=0),
                                            mod.Request(user=N_USERS,
                                                        now=0)])),
            _raised(lambda: gw.observe((N_USERS, 1, 5))),
            _raised(lambda: gw.observe_many([1, N_USERS], [1, 2], [3, 4])),
            _raised(lambda: gw.observe_many([1, 2], [1], [3, 4])),
            _raised(lambda: gw.observe("nope")),
            (gw.pending, gw.injector.batch._log.n_events),
        ]
        pairs.append(out)
    assert pairs[1] == pairs[0]


def test_as_event_coercions():
    class Rec:
        user, item, ts = 4, 5, 6
    for ev in [(1, 2, 3), [1, 2, 3], api.Event(1, 2, 3), Rec()]:
        got = api.as_event(ev)
        assert dataclasses.astuple(got) == dataclasses.astuple(
            jax_api.as_event(ev))
    assert _raised(lambda: api.as_event("nope")) == _raised(
        lambda: jax_api.as_event("nope"))


@pytest.mark.parametrize("arms", [("control", "treatment"), ("a", "b", "c")])
def test_hash_arm_and_assign_arms_match(arms):
    users = np.arange(500)
    for salt in (0, 1, 17):
        assert api.assign_arms(users, arms, salt) == jax_api.assign_arms(
            users, arms, salt)
        assert [api.hash_arm(int(u), arms, salt) for u in users[:50]] == \
            [jax_api.hash_arm(int(u), arms, salt) for u in users[:50]]
    assert _raised(lambda: api.hash_arm(1, ())) == _raised(
        lambda: jax_api.hash_arm(1, ()))


def test_prefill_state_cache_matches_jax():
    """A seeded mix of put/get/rekey/drop/pending/invalidate on both
    packages' caches (CPU tensors here, numpy there, of the same shapes
    and dtypes): same keys in the same LRU order, same counters and
    per-shard bytes, under an entry and a byte budget."""
    rng = np.random.RandomState(0)

    def entry(rows, mod):
        arrs = {"k": np.zeros((2, 1, rows, 2, 4), np.float32),
                "valid": np.ones((1, rows), bool),
                "last": np.zeros(9, np.float32)}
        if mod == "repro":
            return {"caches": {"pos0": {"k": arrs["k"]}},
                    "valid": arrs["valid"], "last_logits": arrs["last"]}
        return {"caches": {"pos0": {"k": torch.from_numpy(arrs["k"])}},
                "valid": torch.from_numpy(arrs["valid"]),
                "last_logits": torch.from_numpy(arrs["last"])}

    caches = {"repro": jax_scheduler.PrefillStateCache(6, 9000, shards=3),
              "repro_torch": PrefillStateCache(6, 9000, shards=3)}
    for step in range(300):
        op = rng.randint(7)
        u, g = int(rng.randint(12)), int(rng.randint(3))
        rows = int(rng.randint(1, 12))
        tokens = list(rng.randint(1, 9, rng.randint(0, 3)))
        for pkg, c in caches.items():
            if op <= 1:
                c.put(u, g, entry(rows, pkg))
            elif op == 2:
                c.get(u, g)
            elif op == 3:
                c.rekey_generation(g, (g + 1) % 3, [u, (u + 5) % 12],
                                   retain_changed=bool(step % 2))
            elif op == 4:
                c.rekey_entry(u, g, (g + 1) % 3)
            elif op == 5 and c.has_entry(u, g):
                c.set_pending(u, g, tokens)
            elif op == 6:
                c.drop(u, g) if step % 3 else c.invalidate_except(g)
        j, t = caches["repro"], caches["repro_torch"]
        assert list(t._entries) == list(j._entries)
        assert t.stats() == j.stats()
        assert t._handoff_stale == j._handoff_stale
        assert [t.get_pending(*k) for k in t._entries] == \
            [j.get_pending(*k) for k in j._entries]


def test_row_plumbing_round_trip_and_fresh_storage(engine):
    """``_host_state`` -> ``_slice_row`` -> ``_cat_rows`` gives back the
    pane bit for bit in new storage: writing into the assembled pane
    leaves the cached rows as they were."""
    toks, valid = engine.pad_tokens([[5, 6, 7], [8], [], [9, 10]],
                                    engine.scfg.prefill_len)
    state = engine.prefill(toks, valid, logits_last_only=True)
    host = scheduler._host_state(state)
    rows = [scheduler._slice_row(host, r) for r in range(4)]
    pane = scheduler._cat_rows(rows, 4, engine.device)
    for name in ("k", "v"):
        assert torch.equal(pane["caches"]["pos0"][name],
                           state["caches"]["pos0"][name])
    assert torch.equal(pane["valid"], state["valid"])
    assert torch.equal(pane["next_pos"], state["next_pos"])
    kept = [r["caches"]["pos0"]["k"].clone() for r in rows]
    pane["caches"]["pos0"]["k"].fill_(7.0)
    state["caches"]["pos0"]["k"].fill_(3.0)
    for r, k in zip(rows, kept):
        assert torch.equal(r["caches"]["pos0"]["k"], k)
    short = scheduler._cat_rows(rows[:2], 4, engine.device)
    assert torch.equal(short["valid"][2], rows[0]["valid"][0])


def test_prefill_logits_last_only(engine):
    """``logits_last_only`` returns the full prefill's last position's
    logits and the same caches."""
    toks, valid = engine.pad_tokens([[5, 6, 7], list(range(1, 40)), [], [9]],
                                    engine.scfg.prefill_len)
    full = engine.prefill(toks, valid)
    last = engine.prefill(toks, valid, logits_last_only=True)
    assert last["logits"].shape == (4, 1, engine.cfg.vocab_padded)
    torch.testing.assert_close(last["logits"][:, -1], full["logits"][:, -1],
                               atol=1e-6, rtol=1e-6)
    for name in ("k", "v"):
        assert torch.equal(last["caches"]["pos0"][name],
                           full["caches"]["pos0"][name])
    assert torch.equal(last["next_pos"], full["next_pos"])
    assert engine.data_shards == 1


def test_injection_server_shim_warns_and_matches_gateway(engine):
    """``serve(users, now)`` warns and is ``submit_many`` + ``flush`` bit
    for bit, over three waves with events between them."""
    srv = InjectionServer(engine, make_injector("repro_torch"),
                          ServerConfig(slate_len=3, cache_entries=64))
    gw = _gateway(engine)
    rng = np.random.RandomState(3)
    now = T0
    for wave in range(3):
        u = rng.randint(0, N_USERS, 10)
        for g in (srv.gateway, gw):
            g.observe_many(u, (u + 3) % N_ITEMS, np.full(10, now - 30))
        q = rng.randint(0, N_USERS, 11)
        with pytest.warns(DeprecationWarning, match="deprecated"):
            r = srv.serve(q, now)
        assert isinstance(r, ServeResult)
        tk = gw.submit_many([api.Request(user=int(x), now=now) for x in q])
        gw.flush(now)
        assert np.array_equal(r.slate, np.stack([t.response.slate
                                                 for t in tk]))
        assert np.array_equal(r.scores, np.stack([t.response.scores
                                                  for t in tk]))
        assert r.cache_hits + r.cache_misses == len(q)
        now += 300
    assert srv.stats().paths == gw.stats().paths
    assert srv.requests == gw.requests and srv.panes == gw.panes
    with pytest.warns(DeprecationWarning):
        empty = srv.serve([], now)
    assert empty.slate.shape == (0, 3)
    assert empty.scores.shape == (0, engine.cfg.vocab_padded)


def _patch_pair():
    """A JAX Gateway and a port Gateway, each on an engine of its own
    (patches write into it), and a port trainer on the port's log."""
    from repro.serving.scheduler import Gateway as JaxGateway
    from repro_torch.training import (AdamWConfig, OnlineTrainer,
                                      OnlineTrainerConfig, TrainConfig)

    jgw = JaxGateway(tiny_engine(), make_injector("repro"),
                     jax_scheduler.ServerConfig(slate_len=3))
    gw = _gateway(port_engine(tiny_engine()))
    tr = OnlineTrainer(gw.engine.cfg, gw.engine.params, gw.injector.batch.log,
                       cfg=OnlineTrainerConfig(),
                       train_cfg=TrainConfig(
                           adamw=AdamWConfig(lr=3e-2, warmup_steps=2),
                           remat=False, param_dtype=torch.float32),
                       device="cpu")
    return jgw, gw, tr


def test_install_patch_base_version_guard():
    """Patches install in order only; a skipped or rewound one raises the
    JAX Gateway's ``ValueError`` and leaves the served version."""
    jgw, gw, tr = _patch_pair()
    assert tr.step() is not None
    p1, p2 = tr.make_patch(), tr.make_patch()     # p2 is based on version 1
    assert (p1.base_version, p1.version, p2.base_version) == (0, 1, 1)
    got = _raised(lambda: gw.install_patch(p2))
    assert got == _raised(lambda: jgw.install_patch(p2))
    assert got[0] == "ValueError"
    assert gw.stats().model_version == 0 and gw.stats().patches_applied == 0
    assert gw.install_patch(p1) == p1.n_leaves
    gw.install_patch(p2)
    assert gw.stats().model_version == 2 and gw.stats().patches_applied == 2
    assert _raised(lambda: gw.install_patch(p1))[0] == "ValueError"
    assert gw.stats().model_version == 2


def test_attach_trainer_version_check():
    """A trainer whose version is not the served one is refused with the
    JAX Gateway's message; a matching one is drained at ``tick``, and
    detaching (``None``) stops the drain."""
    jgw, gw, tr = _patch_pair()
    tr.make_patch()                                  # tr is at version 1
    got = _raised(lambda: gw.attach_trainer(tr))
    assert got[0] == "ValueError"
    assert got == _raised(lambda: jgw.attach_trainer(tr))
    assert gw._maybe_install_patches() == 0          # nothing attached
    _, gw, tr = _patch_pair()
    gw.attach_trainer(tr)
    assert gw._maybe_install_patches() == 0          # no patch queued yet
    tr.step()
    tr._patch_q.append(tr.make_patch())              # as the worker queues
    gw.tick(T0)
    assert gw.stats().patches_applied == 1 and gw.stats().model_version == 1
    gw.attach_trainer(None)
    assert gw._maybe_install_patches() == 0


@pytest.mark.parametrize("extra,ok", [
    (["--roll-midway", "--rewarm", "4", "--max-wait", "3"], True),
    (["--build-budget", "10", "--roll-midway"], True),
    (["--pool", "8", "--roll-midway"], True),
    (["--ab", "--roll-midway"], True),
    (["--mesh", "2,1", "--roll-midway"], True)])
def test_serve_launcher_loop_on_cpu_without_jax(extra, ok):
    """``python -m repro_torch.launch.serve --loop`` drives the Gateway
    with a seeded trace on the CPU, with ``jax`` made unimportable, from
    the host LRU or (``--pool``) the paged state pool, with ``--ab``'s
    per-request arms, and (``--mesh 2,1``) sharded over two gloo ranks,
    rank 0 printing the JAX launcher's mesh line; the parts not ported
    yet stop it with a message naming their item."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    argv = ["serve", "--arch", "itfi-ranker", "--reduced", "--device", "cpu",
            "--loop", "--users", "40", "--rounds", "2", "--batch", "4",
            "--history", "32", "--fresh", "8"] + extra
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            f"sys.argv = {argv!r}\n"
            "runpy.run_module('repro_torch.launch.serve', "
            "run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         capture_output=True, text=True, timeout=120)
    if not ok:
        assert out.returncode != 0 and "not ported yet" in out.stderr
        assert "ROADMAP.md" in out.stderr
        return
    assert out.returncode == 0, out.stderr
    # warm() clamps to the cache's budget: 8 slots, or 40 LRU entries
    warmed = 8 if "--pool" in extra else 40
    for line in (f"warm: {warmed} prefill states", "round 0:", "round 1:",
                 "-- generation rollover", "telemetry: paths="):
        assert line in out.stdout, out.stdout
    if "--pool" in extra:
        assert "paged state pool: 8 device slots" in out.stdout
        assert "'slots': 8" in out.stdout
    assert ("mesh: data=2 model=1 (2 gloo ranks)" in out.stdout) \
        == ("--mesh" in extra), out.stdout
    if "--mesh" in extra:  # one rank prints
        assert out.stdout.count("round 0:") == 1, out.stdout
        assert "'shards': 2" in out.stdout, out.stdout
    assert ("last-round arms (mixed panes): {" in out.stdout) \
        == ("--ab" in extra), out.stdout


def _launcher_out(pkg, argv, **env):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import runpy, sys\n"
            f"sys.argv = {['serve'] + argv!r}\n"
            f"runpy.run_module('{pkg}.launch.serve', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(root / "src"),
                                  **env),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_serve_launcher_ab_split_equals_jax():
    """``--loop --ab`` on the CPU: the port's launcher assigns the same
    users to the same arms as the JAX launcher on the same seed, so the
    last round's per-arm split is the same line in both."""
    argv = ["--arch", "itfi-ranker", "--reduced", "--loop", "--users", "40",
            "--rounds", "2", "--batch", "4", "--history", "32", "--fresh",
            "8", "--ab", "--seed", "3"]
    want = _launcher_out("repro", argv, JAX_PLATFORMS="cpu")
    got = _launcher_out("repro_torch", argv + ["--device", "cpu"])

    def split(text):
        lines = [x for x in text.splitlines()
                 if x.startswith("last-round arms (mixed panes): ")]
        assert len(lines) == 1, text
        return lines[0]
    assert split(got) == split(want)
    assert "'control'" in split(got) and "'treatment'" in split(got)


def test_serve_launcher_defaults_match_jax():
    """The port's launcher has the JAX launcher's flags and defaults (its
    own ``--device`` aside). The JAX parser is built inside ``main``, so
    it is caught at its ``parse_args``."""
    import argparse
    from unittest import mock

    from repro.launch import serve as jserve
    from repro_torch.launch.serve import build_parser

    class Caught(Exception):
        pass

    def catch(parser, *args, **kwargs):
        raise Caught(parser)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", catch):
        with pytest.raises(Caught) as caught:
            jserve.main()
    want = vars(caught.value.args[0].parse_args([]))
    got = vars(build_parser().parse_args([]))
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert (got["batch"], got["fresh"], got["decode_steps"]) == (4, 8, 16)
