"""The port's scenario harness (``repro_torch.serving.loadgen``) against
the JAX package's (``repro.serving.loadgen``).

* **Specs and traces.** Every named scenario (``churn_compact``
  included) builds the same spec on both sides, smoke and full size, and
  ``make_trace`` gives the same op stream, bit for bit: the smoke
  fingerprints equal the JAX ones, and the five full-size fingerprints
  equal the JAX package's record in ``BENCH_scenarios.json``.
* **Replays.** Each smoke scenario is replayed through
  ``build_gateway(spec, engine=...)`` on both packages, the JAX side over
  the harness's own JAX engine (``_engine_for``) and the port over the
  same fp32 weights (``torch_port.port_engine``). Every response must
  match: the same request ids, equal shed markers and telemetry, equal
  slates and scores within 1e-5 (XLA and torch order their f32 sums
  differently). Every metric that is not a wall-clock reading, every
  sim-time gate verdict and every ``stats()`` counter must be equal.
  ``mixed_fleet``'s three reduced archs run in
  ``tests/test_torch_scenarios_fleet.py``.
* **SLO logic.** ``evaluate_slo`` on synthetic metrics (every gate
  passing and failing, vacuous wall gates over empty path groups) and
  ``collect_metrics`` on the same tickets give what the JAX functions
  give.
* **Launcher.** ``--scenario diurnal --smoke --device cpu`` runs with
  ``jax`` unimportable and prints the scorecard.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serving import loadgen as jlg
from repro_torch.serving import loadgen as lg
from torch_port import port_engine

ROOT = Path(__file__).resolve().parents[1]
ALL = lg.SCENARIO_NAMES + ("churn_compact",)
TOL = dict(atol=1e-5, rtol=1e-5)
# wall-clock readings: excluded from every equality
WALL_METRICS = ("wall_ms_p99", "boundary_slice_max_ms")
WALL_ROLLOVER = ("build_time_s", "build_slice_max_s")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True)
def one_torch_thread():
    """A replay is tens of thousands of tiny ops, which intra-op threads
    only slow down, badly so on a host shared with other test workers;
    the thread count is put back after each test."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _record():
    with open(ROOT / "BENCH_scenarios.json") as f:
        return {(r["name"], r["arch"]): r for r in json.load(f)["results"]}


# ----------------------------------------------------------------------
# specs and traces
# ----------------------------------------------------------------------

def test_constants_match_jax():
    assert lg.SCENARIO_NAMES == jlg.SCENARIO_NAMES
    assert lg.PATH_GROUPS == jlg.PATH_GROUPS
    assert lg._WALL_BUDGETS == jlg._WALL_BUDGETS
    assert lg.DAY == jlg.DAY
    assert dataclasses.asdict(lg.SLOContract()) == \
        dataclasses.asdict(jlg.SLOContract())
    with pytest.raises(KeyError, match="unknown scenario"):
        lg.get_scenario("nope")


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("name", ALL)
def test_trace_matches_jax(name, smoke):
    spec, jspec = lg.get_scenario(name, smoke), jlg.get_scenario(name, smoke)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    trace, jtrace = lg.make_trace(spec), jlg.make_trace(jspec)
    assert trace.ops == jtrace.ops
    assert (trace.arrivals, trace.events) == (jtrace.arrivals, jtrace.events)
    assert trace.fingerprint == jtrace.fingerprint
    if not smoke and name in lg.SCENARIO_NAMES:
        arch = spec.archs[0] if spec.archs else None
        assert trace.fingerprint == _record()[(name, arch)][
            "trace_fingerprint"]


# ----------------------------------------------------------------------
# replays, response by response
# ----------------------------------------------------------------------

def stats(gw):
    d = gw.stats().as_dict()
    d.pop("patch_install_max_ms")
    for key in WALL_ROLLOVER:
        d["rollover"].pop(key)
    return d


def sim_metrics(metrics):
    return {k: v for k, v in metrics.items() if k not in WALL_METRICS}


def sim_gates(gates):
    return [g for g in gates if not g["gate"].startswith(
        ("wall_ms_p99", "boundary_slice"))]


def replay_pair(name, arch=None, smoke=True):
    """Replay scenario ``name`` (on ``arch`` for mixed_fleet) on both
    packages and check them against each other. Returns the port's
    ``(gateway, tickets, metrics)``."""
    jspec, spec = jlg.get_scenario(name, smoke), lg.get_scenario(name, smoke)
    jeng = jlg._engine_for(jspec, arch)
    gws = (jlg.build_gateway(jspec, arch, engine=jeng),
           lg.build_gateway(spec, arch, engine=port_engine(jeng)))
    pool = np.arange(spec.seen_users or spec.n_users)
    jt, tt = [], []
    for mod, sp, gw, out in zip((jlg, lg), (jspec, spec), gws, (jt, tt)):
        assert gw.warm(pool, sp.start) == len(pool)
        out.extend(mod.replay(gw, mod.make_trace(sp), sp))
    assert len(jt) == len(tt) and all(t.done for t in tt)
    for j, t in zip(jt, tt):
        assert j.request_id == t.request_id
        jr, tr = j.response, t.response
        assert tr.shed == jr.shed
        assert dataclasses.asdict(tr.telemetry) == \
            dataclasses.asdict(jr.telemetry)
        np.testing.assert_array_equal(tr.slate, jr.slate)
        assert tr.scores.dtype == np.float32
        np.testing.assert_allclose(tr.scores, jr.scores, **TOL)
    assert stats(gws[1]) == stats(gws[0])
    jm = jlg.collect_metrics(jt, gws[0].stats())
    tm = lg.collect_metrics(tt, gws[1].stats())
    assert sim_metrics(tm) == sim_metrics(jm)
    (_, jgates), (_, tgates) = (jlg.evaluate_slo(jspec.slo, jm),
                                  lg.evaluate_slo(spec.slo, tm))
    assert sim_gates(tgates) == sim_gates(jgates)
    assert all(g["pass"] for g in sim_gates(tgates))
    # the JAX functions on the port's own tickets: the same numbers
    assert lg.collect_metrics(tt, gws[1].stats()) == \
        jlg.collect_metrics(tt, gws[1].stats())
    return gws[1], tt, tm


@pytest.mark.parametrize("name", ["diurnal", "flash_crowd",
                                  "cold_start_storm", "churn_heavy",
                                  "churn_compact"])
def test_smoke_replay_matches_jax(name):
    gw, tickets, m = replay_pair(name)
    paths = m["paths"]
    if name == "flash_crowd":
        assert m["shed"] > 0
    if name == "cold_start_storm":
        assert m["hit_rate"] == 0.0 and paths["prefill"] == m["served"]
    if name.startswith("churn"):
        assert gw.stats().rollover.rollovers >= 1
    if name == "churn_compact":
        assert paths["decay"] > 0 and gw.stats().ingest["compactions"] > 0
    assert paths["inject"] + paths["prefill"] > 0


# ----------------------------------------------------------------------
# SLO logic
# ----------------------------------------------------------------------

def _metrics(rng, empty_groups=()):
    wall = {g: (None if g in empty_groups else float(rng.uniform(1, 900)))
            for g in ("hit", "fresh", "miss")}
    served = int(rng.randint(1, 500))
    shed = int(rng.randint(0, 50))
    return {"requests": served + shed, "served": served, "shed": shed,
            "shed_rate": shed / (served + shed),
            "deadline_misses": int(rng.randint(0, 3)),
            "deadline_miss_rate": float(rng.uniform(0, 0.1)),
            "hit_rate": float(rng.uniform(0, 1)),
            "queue_delay": {"p50": float(rng.randint(0, 8)),
                            "p99": float(rng.randint(0, 40)),
                            "max": int(rng.randint(0, 60))},
            "wall_ms_p99": wall,
            "boundary_slice_max_ms": float(rng.uniform(0, 20)),
            "paths": {}}


def test_evaluate_slo_matches_jax():
    """Every named scenario's contract, the empty contract and one with
    every gate set, on seeded metrics that pass some gates and fail
    others, with empty path groups (vacuous wall gates) among them."""
    full = dict(queue_delay_p50=4, queue_delay_p99=10,
                max_deadline_miss_rate=0.05, max_shed_rate=0.1, min_shed=3,
                min_hit_rate=0.3, max_hit_rate=0.9,
                wall_ms_p99={"hit": 300.0, "fresh": 250.0, "miss": 400.0},
                max_boundary_slice_ms=5.0)
    contracts = [dataclasses.asdict(lg.get_scenario(n).slo) for n in ALL]
    contracts += [{}, full, dict(full, max_deadline_miss_rate=None,
                                 max_shed_rate=None)]
    rng = np.random.RandomState(0)
    verdicts = set()
    for kw in contracts:
        for empty in ((), ("miss",), ("hit", "fresh", "miss")):
            for _ in range(4):
                m = _metrics(rng, empty)
                got = lg.evaluate_slo(lg.SLOContract(**kw), m)
                assert got == jlg.evaluate_slo(jlg.SLOContract(**kw), m)
                verdicts.add(got[0])
                for g in got[1]:
                    if g["gate"].startswith("wall") and g["actual"] is None:
                        assert g["pass"]
    assert verdicts == {True, False}
    assert lg.evaluate_slo(lg.SLOContract(max_deadline_miss_rate=None,
                                          max_shed_rate=None),
                           _metrics(rng)) == (True, [])


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------

def test_scenario_launcher_runs_on_cpu_without_jax():
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = ['serve', '--scenario', 'diurnal', '--smoke',\n"
        "            '--device', 'cpu']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want_fp = lg.make_trace(lg.get_scenario("diurnal", smoke=True)).fingerprint
    assert f"[None] trace={want_fp}" in out.stdout, out.stdout
    for line in ("scenario diurnal: horizon=400s users=192",
                 "requests=369 served=369 shed=0 deadline_misses=0",
                 "queue delay p50/p99/max = 3/3/3s",
                 "[PASS] queue_delay_p50_s", "[PASS] min_hit_rate",
                 "SLO: "):
        assert line in out.stdout, out.stdout
