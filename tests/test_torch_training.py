"""The port's training substrate (``repro_torch.training``) against the JAX
package's, on the CPU at fp32 with TF32 off.

The same numpy inputs and the same weights (JAX ``init_params``, carried
over with ``weights.params_from_numpy``) go through both packages.
Tolerances, each from how the two frameworks order their f32 work:

* ``cross_entropy``: within 1e-6 (``logsumexp`` sums in another order);
* ``lr_schedule``: bit-equal in float32, at every step of a sweep that
  includes ``warmup_steps`` (the same float32 operations in the same
  order);
* ``adamw_update`` and ``make_train_step``: within 1e-5 absolute and
  relative (``pow``, the global norm's sum and the backward pass's
  reductions are ordered differently). One step and several, with
  ``microbatches`` 1 and 2, on ``tiny-test`` and ``reduced(mamba2-780m)``.
  The gradients themselves agree to ~3e-7. The train-step cases set
  AdamW's ``eps`` to 1e-3: an update is about ``lr * g / (|g| + eps)``,
  which multiplies a gradient's rounding difference by up to
  ``lr / eps``, so at the default 1e-8 a gradient element near zero that
  the two frameworks round ~1e-8 apart moves its weight ~1e-4 more in
  one than in the other.

The train step runs the model's plain path: gradients reach ``wq`` (the
kernels, which have no backward, would leave it without one), and the
kernel wrappers' guard refuses a launch that autograd would record.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_model_config
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models.model import init_params as jax_init_params
from repro.training import losses as jax_losses
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_train
from repro_torch.kernels import _build
from repro_torch.models import attention as attention_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import flatten_with_keystr
from repro_torch.models.model import forward
from repro_torch.training import losses, optimizer, train_loop
from repro_torch.weights import params_from_numpy
from torch_port import port_cfg

TOL = dict(atol=1e-5, rtol=1e-5)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), **(tol or TOL))


def _cfgs(arch):
    jcfg = (jax_reduced(jax_get_config("mamba2-780m")) if arch == "mamba2"
            else tiny_model_config())
    return jcfg, port_cfg(jcfg)


def _params(jcfg, cfg):
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu")


def _batch(cfg, rng, b=4, s=16):
    """Right-aligned histories with padding, as the online trainer's."""
    toks = rng.randint(1, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    lens = rng.randint(2, s + 2, b)
    valid = (np.arange(s + 1)[None, :] >= (s + 1 - lens)[:, None])
    toks = np.where(valid, toks, 0).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "valid": valid[:, :-1].astype(np.int32),
            "loss_mask": (valid[:, :-1] & valid[:, 1:]).astype(np.int32)}


@pytest.mark.parametrize("with_valid", [False, True])
def test_cross_entropy_matches_jax(with_valid):
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 7, 40).astype(np.float32) * 4
    logits[..., 33:] = -1e30                      # the padded vocab
    labels = rng.randint(0, 33, (3, 7)).astype(np.int32)
    labels[0, :3] = logits[0, :3, :33].argmax(-1)  # some hits
    valid = rng.rand(3, 7) < 0.6 if with_valid else None
    want = jax_losses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if valid is None else jnp.asarray(valid))
    got = losses.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if valid is None else torch.from_numpy(valid))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.dim() == 0
        _close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cfg_kw", [
    {}, dict(lr=1e-3, warmup_steps=10, total_steps=100),
    dict(lr=3e-2, warmup_steps=2, total_steps=1000, min_lr_ratio=0.0),
    dict(warmup_steps=0, total_steps=5)])
def test_lr_schedule_bit_equal(cfg_kw):
    """float32 bit for bit over a sweep through warmup, the switch, the
    cosine and past the end; ``lr=1e-3`` at ``step == warmup_steps`` is
    float32's 0.0010000000474974513, unclamped."""
    jcfg = jax_opt.AdamWConfig(**cfg_kw)
    cfg = optimizer.AdamWConfig(**cfg_kw)
    w = cfg.warmup_steps
    steps = sorted({0, 1, max(w - 1, 0), w, w + 1, cfg.total_steps // 2,
                    cfg.total_steps, cfg.total_steps + 7})
    for step in steps:
        want = np.asarray(jax_opt.lr_schedule(jcfg, jnp.int32(step)))
        got = optimizer.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), (step, got, want)
    if cfg_kw.get("lr") == 1e-3:
        assert float(optimizer.lr_schedule(cfg, torch.tensor(w))) == \
            0.0010000000474974513


@pytest.mark.parametrize("cfg_kw", [
    {}, dict(lr=1e-3, warmup_steps=50, total_steps=10),
    dict(lr=3e-2, warmup_steps=2, total_steps=1000, min_lr_ratio=0.0)])
def test_lr_schedule_every_step(cfg_kw):
    """Every step, one 0-dim step at a time as the train step calls it,
    against the JAX function called eagerly: bit-equal through the warmup,
    and within 1e-6 relative (1e-7 of ``lr`` absolute) on the cosine,
    where ``torch.cos`` and XLA's cos differ by a few float32 ulps. (Under
    ``jax.jit`` the JAX function itself gives some warmup steps one ulp
    off its eager value.)"""
    jcfg = jax_opt.AdamWConfig(**cfg_kw)
    cfg = optimizer.AdamWConfig(**cfg_kw)
    steps = range(min(cfg.total_steps + 8, 1200))
    want = np.array([np.asarray(jax_opt.lr_schedule(jcfg, jnp.int32(s)))
                     for s in steps])
    got = np.array([optimizer.lr_schedule(
        cfg, torch.tensor(s, dtype=torch.int32)).numpy() for s in steps])
    w = min(cfg.warmup_steps, len(want))
    assert got[:w].tobytes() == want[:w].tobytes()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * cfg.lr)


NO_DECAY = ("scale", "norm_scale", "A_log", "D", "dt_bias", "bq", "bk", "bv",
            "conv_bias_x", "conv_bias_B", "conv_bias_C")


@pytest.mark.parametrize("name", NO_DECAY + ("wq", "table", "wz", "conv_x",
                                             "out_proj"))
def test_is_matrix_matches_jax(name):
    want = jax_opt._is_matrix((jax.tree_util.DictKey("blocks"),
                               jax.tree_util.DictKey(name)))
    assert optimizer._is_matrix(("blocks", name)) == want
    assert want == (name not in NO_DECAY)


def test_adamw_update_matches_jax():
    """Three updates on a tree with decayed and undecayed leaves, with
    the gradients clipped (grad_clip below their norm) and not."""
    rng = np.random.RandomState(1)
    shapes = {"blocks": {"pos0": {"ssm": {"A_log": (4,), "D": (4,),
                                          "dt_bias": (4,), "wx": (6, 8)},
                                  "norm1": {"scale": (6,)}}},
              "embed": {"table": (10, 6)}}

    def tree(fn, t=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in t.items()}
    p = tree(lambda s: rng.randn(*s).astype(np.float32))
    for clip in (1e3, 0.5):
        jcfg = jax_opt.AdamWConfig(lr=1e-2, warmup_steps=2, grad_clip=clip)
        cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=2, grad_clip=clip)
        jo = jax_opt.init_opt_state(jax.tree.map(jnp.asarray, p))
        to = optimizer.init_opt_state(jax.tree.map(torch.from_numpy, p))
        for _ in range(3):
            g = tree(lambda s: rng.randn(*s).astype(np.float32))
            jp, jo, jst = jax_opt.adamw_update(
                jcfg, jax.tree.map(jnp.asarray, g), jo, jnp.float32)
            tp, to, tst = optimizer.adamw_update(
                cfg, jax.tree.map(torch.from_numpy, g), to, torch.float32)
            for (k, a), (k2, b) in zip(flatten_with_keystr(tp),
                                       jax.tree_util.tree_flatten_with_path(
                                           jp)[0]):
                assert k == jax.tree_util.keystr(k2)
                _close(a, b)
            for name in ("grad_norm", "lr"):
                _close(tst[name], jst[name])
            assert int(to.step) == int(jo.step)
        # an undecayed leaf at zero gradient stays put; a matrix decays
        zero = jax.tree.map(lambda a: torch.zeros(a.shape), tp)
        tp2, _, _ = optimizer.adamw_update(
            optimizer.AdamWConfig(lr=1e-2, warmup_steps=0), zero,
            optimizer.init_opt_state(tp), torch.float32)
        assert torch.equal(tp2["blocks"]["pos0"]["ssm"]["A_log"],
                           tp["blocks"]["pos0"]["ssm"]["A_log"])
        assert not torch.equal(tp2["embed"]["table"], tp["embed"]["table"])


@pytest.mark.parametrize("arch,microbatches,steps", [
    ("tiny", 1, 1), ("tiny", 1, 3), ("tiny", 2, 3), ("mamba2", 1, 2),
    ("mamba2", 2, 1)])
def test_train_step_matches_jax(arch, microbatches, steps):
    """``make_train_step`` against the JAX step (jitted), from the same
    weights over the same batches: params, f32 master, moments and the
    step's metrics within 1e-5 after every step."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg, cfg)
    kw = dict(lr=3e-2, warmup_steps=2, total_steps=100, eps=1e-3)
    jstep = jax.jit(jax_train.make_train_step(jcfg, jax_train.TrainConfig(
        adamw=jax_opt.AdamWConfig(**kw), microbatches=microbatches,
        remat=True, param_dtype=jnp.float32)))
    tstep = train_loop.make_train_step(cfg, train_loop.TrainConfig(
        adamw=optimizer.AdamWConfig(**kw), microbatches=microbatches,
        remat=True, param_dtype=torch.float32))
    jo, to = jax_opt.init_opt_state(jp), optimizer.init_opt_state(tp)
    rng = np.random.RandomState(2)
    for _ in range(steps):
        batch = _batch(cfg, rng)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, batch)
        for name in ("loss", "acc", "grad_norm", "lr"):
            _close(tm[name], jm[name])
        for tree_t, tree_j in ((tp, jp), (to.master, jo.master),
                               (to.m, jo.m), (to.v, jo.v)):
            got = dict(flatten_with_keystr(tree_t))
            for path, want in jax.tree_util.tree_flatten_with_path(tree_j)[0]:
                _close(got[jax.tree_util.keystr(path)], want)


def test_train_loop_runs_and_learns():
    """``train`` over a learnable stream (copy the previous token): the
    loss falls, and the history carries the JAX metrics' names."""
    jcfg, cfg = _cfgs("tiny")
    _, tp = _params(jcfg, cfg)
    rng = np.random.RandomState(0)

    def batch():
        toks = rng.randint(1, 97, (8, 12)).astype(np.int32)
        return {"tokens": toks,
                "labels": np.concatenate([toks[:, :1], toks[:, :-1]], 1)}
    tcfg = train_loop.TrainConfig(
        adamw=optimizer.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60),
        remat=False, param_dtype=torch.float32)
    out = train_loop.train(cfg, tcfg, tp, optimizer.init_opt_state(tp),
                           (batch() for _ in range(60)), log=None)
    h = out["history"]
    assert set(h[0]) == {"loss", "acc", "moe_aux", "grad_norm", "lr"}
    assert np.mean([x["loss"] for x in h[-5:]]) < \
        np.mean([x["loss"] for x in h[:5]]) * 0.8


def test_gradients_reach_wq_through_the_plain_path():
    jcfg, cfg = _cfgs("tiny")
    _, tp = _params(jcfg, cfg)
    loss_fn = train_loop.make_loss_fn(cfg, train_loop.TrainConfig(
        remat=False, param_dtype=torch.float32))
    live = jax.tree.map(lambda p: p.clone().requires_grad_(True), tp)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(cfg, np.random.RandomState(3)).items()}
    loss, _ = loss_fn(live, batch)
    loss.backward()
    for name in ("wq", "wk", "wv", "wo"):
        g = live["blocks"]["pos0"]["attn"][name].grad
        assert g is not None and g.abs().max() > 0, name


def test_training_path_launches_no_kernel(monkeypatch):
    """``forward(use_kernels=False)`` never reaches a kernel wrapper (on
    the card each would launch); ``use_kernels=True`` does."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called")
    monkeypatch.setattr(attention_mod, "flash_attention", refuse)
    monkeypatch.setattr(ssm_mod, "ssd_scan", refuse)
    for arch in ("tiny", "mamba2"):
        jcfg, cfg = _cfgs(arch)
        _, tp = _params(jcfg, cfg)
        toks = torch.ones((2, 8), dtype=torch.int32)
        assert forward(tp, cfg, toks, use_kernels=False,
                       remat=True).shape[:2] == (2, 8)
        with pytest.raises(AssertionError, match="kernel wrapper"):
            forward(tp, cfg, toks)


def test_kernel_guard_refuses_grad():
    """The guard each float kernel wrapper runs before a CUDA launch:
    an input that requires grad under grad mode raises; under
    ``no_grad``, or with no such input, it passes."""
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.check_no_grad("flash_attention", y, x)
    _build.check_no_grad("flash_attention", y, None)
    with torch.no_grad():
        _build.check_no_grad("ssd_scan", x, y)
