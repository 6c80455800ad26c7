"""The port's A/B harness (``repro_torch.core.ab``) against the JAX one.

- ``core/metrics.py`` is bit-equal: the same floats from the same tallies.
- ``request_arm``/``arm_requests`` bucket 10k users the same way under 3
  salts, for the two-arm and the decay experiments.
- The slice as a whole: with the same untrained ``default_sim_model``
  weights carried across in fp32 (TF32 off), ``make_platform`` and
  ``run_arm`` give bit-equal ``ArmResult``s for every arm (control,
  treatment, consistent, ``stale_3600s``) over 2 days of a 50-user world
  built from the same bootstrap logs. The consistent mode never puts its
  SEP token in a slate.
- ``train_ranker`` from JAX's initial weights (monkeypatched in) sees the
  same batches bit for bit, and every step's loss of a short run agrees
  within ``LOSS_TOL`` (below), with bf16 and with f32 params.
- The port's ``run_experiment`` passes ``tests/test_ab_integration.py``'s
  checks at its scale.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.ab as jab
import repro.core.metrics as jmetrics
import repro.data.synthetic as jsyn
import repro_torch.core.ab as tab
import repro_torch.core.metrics as tmetrics
import repro_torch.data.synthetic as tsyn
from repro.models.model import init_params as jax_init_params
from repro_torch.configs import ModelConfig
from repro_torch.data.loader import sep_token
from repro_torch.weights import params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False

# A short train_ranker run's per-step losses, port against JAX, by the
# params' dtype. Step 0 runs on the same f32 weights in both (< 1e-5).
# With f32 params (``param_dtype`` patched to f32 in both harnesses)
# every step stays within ``tests/test_torch_training.py``'s train-step
# tolerance, 1e-5. With the default bf16 params, from step 1 on the
# forward runs in bf16, and XLA keeps f32 intermediates inside its fused
# ops where torch rounds each op's output to bf16 (2**-8 relative): the
# losses of a 10-step run then differ by up to ~3.4e-3 (of ~6.5; both
# cutoffs, lr 1e-3 and 3e-2). 1e-2 leaves ~3x room; the f32 case is the
# one that holds the gradients and AdamW.
LOSS_TOL = {"bf16": 1e-2, "f32": 1e-5}

WORLD = dict(n_users=50, n_items=250, sessions_per_day=1.5, seed=0)
BOOT_DAYS, AB_DAYS = 2, 2
ARMS = {"control": dict(policy="batch"),
        "treatment": dict(policy="inject"),
        "consistent": dict(policy="inject", mode="consistent"),
        "stale_3600s": dict(policy="batch", staleness=3600)}


def _ab(pkg, **kw):
    syn = jsyn if pkg is jab else tsyn
    base = dict(world=syn.WorldConfig(**WORLD), bootstrap_days=BOOT_DAYS,
                gen1_days=1, ab_days=AB_DAYS, feature_len=24,
                train_epochs=1, train_batch=32, max_examples=1500,
                latency_arms=(3600,))
    return pkg.ABConfig(**{**base, **kw})


def _port_cfg(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


# ----------------------------------------------------------------------
# metrics and arm assignment
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_metrics_bit_equal(seed):
    rng = np.random.RandomState(seed)
    n = 300
    ti, ci = rng.poisson(6, n), rng.poisson(6, n)
    tw = rng.binomial(ti, 0.3 + 0.02 * seed)
    cw = rng.binomial(ci, 0.3)
    ti[:7] = 0                                 # users a side never saw
    for n_boot, s in ((50, seed), (2000, 11)):
        got = tmetrics.paired_user_test(tw, ti, cw, ci, n_boot=n_boot, seed=s)
        want = jmetrics.paired_user_test(tw, ti, cw, ci, n_boot=n_boot,
                                         seed=s)
        assert got == want
        assert all(type(got[k]) is type(want[k]) for k in want)
    for args in ((int(tw.sum()), int(ti.sum()), int(cw.sum()),
                  int(ci.sum())), (0, 0, 0, 0), (3, 10, 3, 10)):
        assert tmetrics.two_proportion_z(*args) == \
            jmetrics.two_proportion_z(*args)
    days = [{"impressions": int(a), "slate_watches": int(b)}
            for a, b in zip(ti[:5], tw[:5])]
    assert tmetrics.summarize_arm("t", days) == \
        jmetrics.summarize_arm("t", days)
    for pkg in (tmetrics, jmetrics):
        assert pkg.ArmStats("x", 0, 0).ctr == 0.0
    assert tmetrics.ArmStats("x", 40, 9).ctr == jmetrics.ArmStats(
        "x", 40, 9).ctr


@pytest.mark.parametrize("salt", [0, 1, 12345])
def test_arm_assignment_equals_jax(salt):
    users = np.arange(10_000)
    for arms in (None, tab.DECAY_ARM_POLICIES):
        jarms = None if arms is None else jab.DECAY_ARM_POLICIES
        got = [tab.request_arm(u, salt, arms) for u in users]
        assert got == [jab.request_arm(u, salt, jarms) for u in users]
        assert set(got) == set(arms or tab.ARM_POLICIES)
        treqs = tab.arm_requests(users, 777, salt, arms)
        jreqs = jab.arm_requests(users, 777, salt, jarms)
        fields = ("user", "now", "policy", "tag", "slate_len", "deadline")
        assert [tuple(getattr(r, f) for f in fields) for r in treqs] == \
            [tuple(getattr(r, f) for f in fields) for r in jreqs]
    assert tab.ARM_POLICIES == jab.ARM_POLICIES
    assert tab.DECAY_ARM_POLICIES == jab.DECAY_ARM_POLICIES


def test_configs_equal_jax():
    t, j = tab.ABConfig(), jab.ABConfig()
    for f in dataclasses.fields(tab.ABConfig):
        want = getattr(j, f.name)
        got = getattr(t, f.name)
        if f.name == "world":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    assert [f.name for f in dataclasses.fields(tab.ABConfig)] == \
        [f.name for f in dataclasses.fields(jab.ABConfig)]
    assert _port_cfg(jab.default_sim_model(300)) == \
        tab.default_sim_model(300)


# ----------------------------------------------------------------------
# the slice as a whole: every arm over 2 days from carried weights
# ----------------------------------------------------------------------

def _bootstrap(syn, ab):
    world = syn.World(ab.world)
    serve0 = syn.bootstrap_serve_fn(world, ab.seed)
    events = []
    for day in range(ab.bootstrap_days):
        events += syn.simulate_day(world, day, serve0, lambda e: None,
                                   seed=ab.seed)[0]
    return world, events


@pytest.fixture(scope="module")
def carried():
    """Both packages' bootstrapped worlds and logs, and one set of
    untrained f32 weights in each."""
    jabc, tabc = _ab(jab), _ab(tab)
    jcfg = jab.default_sim_model(WORLD["n_items"])
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = _port_cfg(jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return ((jabc, jcfg, jparams, *_bootstrap(jsyn, jabc)),
            (tabc, cfg, tparams, *_bootstrap(tsyn, tabc)))


@pytest.mark.parametrize("arm", list(ARMS))
def test_run_arm_bit_equal_jax(carried, arm):
    (jabc, jcfg, jparams, jworld, jev), (tabc, cfg, tparams, tworld, tev) = \
        carried
    days = range(BOOT_DAYS, BOOT_DAYS + AB_DAYS)
    jplat = jab.make_platform(jabc, jcfg, jparams, jworld, jev, **ARMS[arm])
    tplat = tab.make_platform(tabc, cfg, tparams, tworld, tev, device="cpu",
                              **ARMS[arm])
    slates = []
    serve = tplat.serve
    tplat.serve = lambda u, t: slates.append(serve(u, t)) or slates[-1]
    want = jab.run_arm(arm, jabc, jplat, copy.deepcopy(jworld), days,
                       log=None)
    got = tab.run_arm(arm, tabc, tplat, copy.deepcopy(tworld), days,
                      log=None)
    assert got.name == want.name == arm
    assert got.day_metrics == want.day_metrics
    for a, b in ((got.user_impressions, want.user_impressions),
                 (got.user_watches, want.user_watches)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.ctr == want.ctr
    assert sum(m["slate_watches"] for m in got.day_metrics) > 0
    assert tplat.serve_calls == jplat.serve_calls > 0
    assert tplat.injector.merge_calls == jplat.injector.merge_calls
    assert (tplat.injector.merge_calls > 0) == (arm == "treatment")
    n_items = WORLD["n_items"]
    s = np.concatenate(slates)
    assert s.min() >= 0 and s.max() < n_items   # SEP = n_items + 1 never
    assert sep_token(n_items) == n_items + 1


def test_consistent_mode_tokens_and_slates(carried):
    """The consistent platform's serve builds ``[batch…, SEP, recent…]``
    tokens with int32 0/1 validity, as the JAX platform does, and its
    slates hold no SEP, no pad and no watched item."""
    from repro.core import pipeline as jpipe
    from repro_torch.core import pipeline as tpipe

    (jabc, jcfg, jparams, jworld, jev), (tabc, cfg, tparams, tworld, tev) = \
        carried
    seen = {}

    def spy(mod, key):
        real = mod._serve_core

        def wrapper(*a, **kw):
            seen[key] = (np.asarray(a[1]), np.asarray(a[2]))
            return real(*a, **kw)
        return wrapper

    users = np.arange(WORLD["n_users"])
    now = BOOT_DAYS * 86400 + 9 * 3600
    kw = ARMS["consistent"]
    jplat = jab.make_platform(jabc, jcfg, jparams, jworld, jev, **kw)
    tplat = tab.make_platform(tabc, cfg, tparams, tworld, tev, device="cpu",
                              **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "_serve_core", spy(jpipe, "jax"))
        mp.setattr(tpipe, "_serve_core", spy(tpipe, "port"))
        want = jplat.serve(users, np.full(len(users), now))
        got = tplat.serve(users, np.full(len(users), now))
    np.testing.assert_array_equal(got, want)
    for a, b in zip(seen["port"], seen["jax"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tokens, valid = seen["port"]
    sep = sep_token(WORLD["n_items"])
    assert valid.dtype == np.int32 and set(np.unique(valid)) <= {0, 1}
    assert (tokens[:len(users)] == sep).sum(1).tolist() == [1] * len(users)
    assert (got < WORLD["n_items"]).all() and (got >= 0).all()
    for row, slate in enumerate(got):
        hist = set((tokens[row][valid[row] > 0] - 1).tolist())
        assert not hist & set(slate.tolist())
    with pytest.raises(ValueError, match="unknown mode"):
        tab.make_platform(tabc, cfg, tparams, tworld, tev, policy="batch",
                          mode="fresh", device="cpu")


# ----------------------------------------------------------------------
# train_ranker
# ----------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["bf16", "f32"])
def test_train_ranker_matches_jax(carried, monkeypatch, param_dtype):
    """Both packages' ``train_ranker`` on the same logs from JAX's initial
    weights: the same batches bit for bit, the same step count, every
    step's loss within ``LOSS_TOL``, and the port's params come back in
    ``param_dtype`` (bf16 by default) on the device."""
    import functools

    import repro_torch.models.model as model_mod

    if param_dtype == "f32":
        monkeypatch.setattr(jab, "TrainConfig", functools.partial(
            jab.TrainConfig, param_dtype=jnp.float32))
        monkeypatch.setattr(tab, "TrainConfig", functools.partial(
            tab.TrainConfig, param_dtype=torch.float32))

    (_, jcfg, _, _, _), (_, cfg, _, _, _) = carried
    kw = dict(bootstrap_days=4, max_examples=160, train_batch=16, seed=1)
    jabc, tabc = _ab(jab, **kw), _ab(tab, **kw)
    jev, tev = _bootstrap(jsyn, jabc)[1], _bootstrap(tsyn, tabc)[1]
    jinit = jax_init_params(jcfg, jax.random.PRNGKey(jabc.seed),
                            dtype=jnp.float32)
    drawn = []

    def carried_init(model_cfg, generator, dtype, device):
        assert dtype == torch.float32 and model_cfg == cfg
        drawn.append(generator.initial_seed())
        return params_from_numpy(jax.tree.map(np.asarray, jinit), cfg,
                                 device=device)
    monkeypatch.setattr(model_mod, "init_params", carried_init)

    runs = {}

    def spy(pkg, key):
        real = pkg.train

        def wrapper(model_cfg, tcfg, params, opt, batches, **kw):
            batches = list(batches)
            out = real(model_cfg, tcfg, params, opt, iter(batches), **kw)
            runs[key] = (batches, out["history"], tcfg)
            return out
        return wrapper
    monkeypatch.setattr(jab, "train", spy(jab, "jax"))
    monkeypatch.setattr(tab, "train", spy(tab, "port"))

    for cutoff in ("midnight", "fresh"):
        jab.train_ranker(jev, jcfg, jabc, cutoff, log=None)
        params = tab.train_ranker(tev, cfg, tabc, cutoff, log=None,
                                  device="cpu")
        (tb, th, tcfg), (jb, jh, jcfg_t) = runs["port"], runs["jax"]
        assert len(tb) == len(jb) >= 6, cutoff
        for i, (a, b) in enumerate(zip(tb, jb)):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, (cutoff, i, k)
                np.testing.assert_array_equal(a[k], b[k])
        assert dataclasses.asdict(tcfg.adamw) == \
            dataclasses.asdict(jcfg_t.adamw)
        assert tcfg.remat is jcfg_t.remat is False
        got = np.array([h["loss"] for h in th])
        want = np.array([h["loss"] for h in jh])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOSS_TOL[param_dtype], err_msg=cutoff)
        assert abs(got[0] - want[0]) < 1e-5, cutoff   # same f32 weights
        # one float32 ulp: JAX's jitted step computes some warmup steps'
        # lr one ulp off its eager ``lr_schedule``, which the port's equals
        np.testing.assert_array_max_ulp(
            np.float32([h["lr"] for h in th]),
            np.float32([h["lr"] for h in jh]), maxulp=1)
        leaf = params["embed"]["table"]
        assert leaf.dtype == {"bf16": torch.bfloat16,
                              "f32": torch.float32}[param_dtype]
        assert leaf.device.type == "cpu"
    assert drawn == [tabc.seed, tabc.seed]


# ----------------------------------------------------------------------
# the whole experiment, at tests/test_ab_integration.py's scale
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def report():
    return tab.run_experiment(_ab(tab), log=None, device="cpu")


def test_run_experiment_all_arms_present(report):
    assert set(report["arms"]) == {"control", "treatment", "consistent",
                                   "stale_3600s"}
    assert set(report["results"]) == set(report["arms"])


def test_run_experiment_paired_impressions_identical(report):
    """Common random numbers: every arm faces the same impressions, user
    by user."""
    imps = {a["impressions"] for a in report["arms"].values()}
    assert len(imps) == 1
    ui = [r.user_impressions for r in report["results"].values()]
    for x in ui[1:]:
        np.testing.assert_array_equal(x, ui[0])


def test_run_experiment_tests_structure(report):
    assert set(report["tests"]) == {"treatment_vs_control",
                                    "consistent_vs_control",
                                    "stale_3600s_vs_control"}
    for t in report["tests"].values():
        for key in ("lift", "ci_lo", "ci_hi", "p_t", "significant",
                    "z_pooled", "p_pooled"):
            assert key in t
        assert t["ci_lo"] <= t["lift"] <= t["ci_hi"]


def test_run_experiment_ctrs_in_sane_range(report):
    for a in report["arms"].values():
        assert 0.0 < a["ctr"] < 0.9
