"""The port's one-device step layer (``launch/steps.py``) and
``make_serve_step`` against the JAX package's.

``microbatches_for`` and ``arch_for_shape`` must equal the JAX functions
at every assigned arch and input shape. ``make_step_and_inputs(...,
device="meta")`` must give example args of the shapes and dtypes of the
JAX ``make_step_and_specs`` on a 1x1 mesh, leaf for leaf, with nothing
allocated. At a tiny shape (seq 32, batch 2) on reduced ``musicgen-large``,
``llava-next-34b`` and ``llama3.2-1b`` (JAX weights carried over in fp32,
TF32 off), each step kind's outputs must agree with the JAX step's on the
same inputs within 1e-5: the train step's metrics and optimizer state,
the prefill step's last logits and caches, the serve step's token and
caches. The port's serve step writes into the caches it is given, as the
JAX dry-run donates them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import InputShape as JaxInputShape
from repro.launch import steps as jax_steps
from repro.launch.mesh import make_serving_mesh
from repro.models import model as jax_model
from repro.serving.engine import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config
from repro_torch.configs.archs import ASSIGNED
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.launch import steps
from repro_torch.models import model
from repro_torch.models.common import flatten_with_keystr
from repro_torch.serving import make_serve_step
from repro_torch.weights import params_from_numpy
from torch_port import port_cfg

TOL = dict(atol=1e-5, rtol=1e-5)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TINY_ARCHS = ("musicgen-large", "llava-next-34b", "llama3.2-1b")


def _mesh():
    return make_serving_mesh(1, 1)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_microbatches_and_arch_for_shape_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert steps.LONG_CONTEXT_WINDOW == jax_steps.LONG_CONTEXT_WINDOW
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        for kw in ({}, {"dp": 1, "tp": 1}, {"dp": 4, "tp": 2},
                   {"act_budget": 2.0 ** 20, "dp": 1, "tp": 1}):
            assert steps.microbatches_for(cfg, shape, **kw) == \
                jax_steps.microbatches_for(jcfg, jshape, **kw), (name, kw)
        got = steps.arch_for_shape(cfg, shape)
        want = jax_steps.arch_for_shape(jcfg, jshape)
        assert got.sliding_window == want.sliding_window, name
        assert (got is cfg) == (want is jcfg), name


def _specs(tree, flatten):
    return {path: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for path, x in flatten(tree)}


def _jax_flat(tree):
    return [(jax.tree_util.keystr(p), x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_same_specs(got, want, what):
    g, w = _specs(got, flatten_with_keystr), _specs(want, _jax_flat)
    assert g == w, what


@pytest.mark.parametrize("arch", ASSIGNED)
def test_example_args_match_jax_specs(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        _, want, _, _ = jax_steps.make_step_and_specs(jcfg, JAX_SHAPES[name],
                                                      _mesh())
        _, got = steps.make_step_and_inputs(cfg, shape, device="meta")
        leaves = [x for _, x in flatten_with_keystr(list(got))]
        assert all(x.is_meta for x in leaves), name
        assert len(got) == len(want), name
        if shape.kind == "train":
            (p, opt, batch), (jp, jopt, jbatch) = got, want
            _assert_same_specs(p, jp, (name, "params"))
            for field in ("master", "m", "v"):
                _assert_same_specs(getattr(opt, field),
                                   getattr(jopt, field), (name, field))
            assert opt.step.shape == jopt.step.shape == ()
            assert opt.step.dtype == torch.int32
            _assert_same_specs(batch, jbatch, (name, "batch"))
        else:
            for i, (g, w) in enumerate(zip(got, want)):
                _assert_same_specs({"x": g} if isinstance(g, torch.Tensor)
                                   else g, {"x": w} if not isinstance(w, dict)
                                   else w, (name, i))


def _jax_models(arch):
    jcfg = jax_reduced(jax_get_config(arch), d_model=64)
    cfg = port_cfg(jcfg)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _np_batch(cfg, b, s, with_labels, seed):
    """The step layer's batch at a tiny shape, from numpy."""
    args = steps.make_batch(cfg, b, s, with_labels=with_labels,
                            device="meta")
    rng = np.random.RandomState(seed)
    out = {}
    for k, x in args.items():
        if k == "prefix_embeds":
            out[k] = (rng.standard_normal(tuple(x.shape)) * 0.02).astype(
                np.float32)
        elif k == "loss_mask":
            pfx = args["prefix_embeds"].shape[1]
            mask = np.ones(tuple(x.shape), bool)
            mask[:, :pfx] = False
            out[k] = mask
        else:
            out[k] = rng.randint(1, cfg.vocab_size, tuple(x.shape)).astype(
                np.int32)
    return out


def _close_trees(got, want):
    g = dict(flatten_with_keystr(got))
    w = _jax_flat(want)
    assert set(g) == {p for p, _ in w}
    for path, x in w:
        np.testing.assert_allclose(g[path].float().numpy(),
                                   np.asarray(x, np.float32), **TOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch", TINY_ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_tiny_step_matches_jax(arch, kind):
    jcfg, jparams, cfg, params = _jax_models(arch)
    shape = InputShape(f"tiny_{kind}", 32, 2, kind)
    jshape = JaxInputShape(f"tiny_{kind}", 32, 2, kind)
    jstep, _, _, _ = jax_steps.make_step_and_specs(jcfg, jshape, _mesh())
    step, ex = steps.make_step_and_inputs(cfg, shape, device="meta",
                                          dtype=torch.float32)
    jstep = jax.jit(jstep)
    if kind == "train":
        from repro.training.optimizer import init_opt_state as jax_init_opt
        from repro_torch.training.optimizer import init_opt_state
        batch = _np_batch(cfg, 2, 32, True, seed=1)
        assert {k: tuple(x.shape) for k, x in ex[2].items()} == \
            {k: x.shape for k, x in batch.items()}
        jp, jo, jm = jstep(jparams, jax_init_opt(jparams),
                           {k: jnp.asarray(v) for k, v in batch.items()})
        p, o, m = step(params, init_opt_state(params), batch)
        for k in ("loss", "acc", "moe_aux", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                       **TOL, err_msg=k)
        for field in ("master", "m", "v"):
            _close_trees(getattr(o, field), getattr(jo, field))
        assert int(o.step) == int(jo.step) == 1
        # the port's params are its f32 master (param dtype f32 here)
        for (path, x), (_, y) in zip(flatten_with_keystr(p),
                                     flatten_with_keystr(o.master)):
            assert torch.equal(x, y), path
    elif kind == "prefill":
        batch = _np_batch(cfg, 2, 32, False, seed=2)
        jlast, jc = jstep(jparams, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        last, c = step(params, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        assert last.shape == (2, cfg.vocab_padded)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
        _close_trees(c, jc)
    else:
        rng = np.random.RandomState(3)
        hist = rng.randint(1, cfg.vocab_size, (2, 20)).astype(np.int32)
        _, jc = jax_model.prefill(jparams, jcfg, jnp.asarray(hist))
        _, c = model.prefill(params, cfg, torch.from_numpy(hist))
        jdc = jax_model.cache_from_prefill(jcfg, jc, 32)
        dc = model.cache_from_prefill(cfg, c, 32)
        for (path, x), (_, y) in zip(flatten_with_keystr(dc),
                                     flatten_with_keystr(ex[1])):
            assert x.shape == y.shape and x.dtype == y.dtype, path
        tok = rng.randint(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full(2, 20, np.int32)
        jn, jdc2 = jstep(jparams, jdc, jnp.asarray(tok), jnp.asarray(pos))
        n, dc2 = step(params, dc, torch.from_numpy(tok),
                      torch.from_numpy(pos))
        assert n.dtype == torch.int32 and n.shape == (2,)
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        _close_trees(dc2, jdc2)
        assert dc2["pos0"]["k"] is dc["pos0"]["k"]     # written in place


def test_make_serve_step_matches_jax_on_wrapped_ring():
    """Three greedy steps on a ring of 16 slots after a 24-token prefill
    (the ring has wrapped), fed each step's token, against the JAX
    ``make_serve_step``; the port's step writes into the caches it is
    given and returns them."""
    jcfg, jparams, cfg, params = _jax_models("llama3.2-1b")
    rng = np.random.RandomState(4)
    hist = rng.randint(1, cfg.vocab_size, (3, 24)).astype(np.int32)
    _, jc = jax_model.prefill(jparams, jcfg, jnp.asarray(hist))
    _, c = model.prefill(params, cfg, torch.from_numpy(hist))
    jdc = jax_model.cache_from_prefill(jcfg, jc, 16)
    dc = model.cache_from_prefill(cfg, c, 16)
    jstep = jax.jit(jax_make_serve_step(jcfg))
    step = make_serve_step(cfg)
    jtok = tok = hist[:, -1:]
    for i in range(3):
        pos = np.full(3, 24 + i, np.int32)
        jn, jdc = jstep(jparams, jdc, jnp.asarray(jtok), jnp.asarray(pos))
        n, out = step(params, dc, torch.from_numpy(np.asarray(tok)),
                      torch.from_numpy(pos))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        _close_trees(out, jdc)
        assert out["pos0"]["k"] is dc["pos0"]["k"]
        jtok, tok = np.asarray(jn)[:, None], n.numpy()[:, None]


def test_cache_shapes_are_meta_and_match_jax():
    for arch in ("musicgen-large", "jamba-v0.1-52b"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        got = model.cache_shapes(cfg, 4, 1024)
        want = jax_model.cache_shapes(jcfg, 4, 1024)
        assert all(x.is_meta for _, x in flatten_with_keystr(got))
        _assert_same_specs(got, want, arch)


def test_step_layer_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.make_step_and_inputs(cfg, SHAPES["prefill_32k"], batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.make_batch(cfg, 1, 8, with_labels=False)
