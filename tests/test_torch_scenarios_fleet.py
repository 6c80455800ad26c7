"""``mixed_fleet`` on the port against the JAX package, and one full-size
scenario against the JAX package's record.

* The smoke ``mixed_fleet`` trace is replayed on each of its three
  reduced archs (``llama3.2-1b``, ``mamba2-780m``,
  ``granite-moe-3b-a800m``: attention, SSM and MoE stacks) through
  ``build_gateway(spec, engine=...)`` on both packages, response by
  response (``test_torch_scenarios.replay_pair``). The three archs'
  counters are equal to each other: they depend on the traffic and the
  scheduler, not on the model.
* ``churn_heavy`` at full size through the port's own ``run_scenario``
  on the CPU (its engine's weights drawn from a torch generator) and the
  JAX package's (``PRNGKey(0)`` weights): every sim-time metric, gate
  verdict and counter is equal, and ``chip_smoke.py``'s check against
  ``BENCH_scenarios.json`` passes on it. The record predates the JAX
  package's handoff retention: its ``rollover.invalidated`` and cache
  counters are not today's, so that check leaves them out, and the
  comparison with the JAX package here holds them.
"""
import numpy as np
import pytest

import chip_smoke
from repro.serving import loadgen as jlg
from repro_torch.serving import loadgen as lg
from test_torch_scenarios import (_record, one_torch_thread,  # noqa: F401
                                  replay_pair, sim_gates, sim_metrics)

FLEET = lg.get_scenario("mixed_fleet").archs


@pytest.mark.parametrize("arch", FLEET)
def test_mixed_fleet_smoke_replay_matches_jax(arch):
    _, _, m = replay_pair("mixed_fleet", arch)
    assert m["paths"]["inject"] > 0 and m["shed"] == 0


def test_full_size_churn_heavy_matches_jax_and_record():
    spec, jspec = lg.get_scenario("churn_heavy"), jlg.get_scenario(
        "churn_heavy")
    (got,) = lg.run_scenario(spec, device="cpu")
    (want,) = jlg.run_scenario(jspec)
    assert got.trace_fingerprint == want.trace_fingerprint
    assert sim_metrics(got.metrics) == sim_metrics(want.metrics)
    assert sim_gates(got.gates) == sim_gates(want.gates)
    assert all(g["pass"] for g in sim_gates(got.gates))
    g, w = got.gateway_stats, want.gateway_stats
    for d in (g, w):
        d.pop("patch_install_max_ms")
        for key in ("build_time_s", "build_slice_max_s"):
            d["rollover"].pop(key)
    g["cache"].pop("bytes_per_shard")
    w["cache"].pop("bytes_per_shard")
    assert g == w
    rec = _record()[("churn_heavy", None)]
    assert chip_smoke.record_mismatches(got.as_dict(), rec) == {}
    # and the check sees a difference where there is one
    bad = got.as_dict()
    bad["gateway_stats"]["panes"] += 1
    bad["metrics"]["queue_delay"]["p99"] = 4.0
    assert set(chip_smoke.record_mismatches(bad, rec)) == {
        "gateway_stats.panes", "metrics.queue_delay"}
    assert np.isclose(got.metrics["hit_rate"], rec["metrics"]["hit_rate"])
