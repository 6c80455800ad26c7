"""The port's step layer on a ("data", "model") mesh
(``launch/steps.py``'s ``make_step_and_specs``) against the JAX
package's.

(i) ``make_step_and_specs(..., device="meta")`` on an abstract mesh gives
    in- and out-specs equal, leaf for leaf, to the ``.spec`` of the JAX
    ``make_step_and_specs``' shardings on an ``AbstractMesh`` of the same
    sizes, and example args of the local shapes (the JAX global shape
    over the shard factor) and dtypes: every assigned arch x the four
    input shapes x meshes 2x2, 1x4, 4x1 and 16x16.
(ii) On a 1x1 mesh (in this process) the train, prefill and decode steps
    are bit for bit the one-device steps of ``make_step_and_inputs``.
(iii) On gloo meshes 1x2, 2x1, 2x2 and 1x4 (one spawned process a rank,
    fp32, TF32 off) a train step from carried JAX weights in the training
    layout matches the JAX one-device ``make_train_step``: loss, acc,
    ``moe_aux`` and ``grad_norm`` within 1e-5, every updated leaf and the
    optimizer state, gathered, within 1e-5 at AdamW eps 1e-3. Each batch
    row has its own count of ``loss_mask`` positions, so a rank's count
    differs from its peers'; microbatches 2 run at 2x1.
(iv) The prefill and decode steps at 2x2 against the JAX one-device
    steps, within 1e-5; decode also at batch 1, where the ring's slots
    are cut over ``data`` and no more than one layer's ring is ever
    gathered whole.
(v) Each rank's gradient of each of its shards equals that block of the
    one-device gradient at 1x2 and 2x1 (and 1x4, the replicated-K/V
    layout), within 1e-5.
At 1x4 "tiny-hd" (``tiny-test`` with 2 heads and 1 kv head) reaches the
head_dim layout: its heads do not divide the model axis, so q is
gathered to every head_dim column and each rank keeps its block.
(vi) ``make_step_and_specs`` refuses a CPU fallback.

Every case of one mesh shape runs in one ``run_on_mesh`` call.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from conftest import tiny_model_config
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.launch import steps as jax_steps
from repro.models import model as jax_model
from repro.serving.engine import make_serve_step as jax_make_serve_step
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_train
from repro_torch.configs import get_config
from repro_torch.configs.archs import ASSIGNED
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.launch import steps
from repro_torch.launch.mesh import close_mesh, make_serving_mesh, run_on_mesh
from repro_torch.models.common import flatten_with_keystr
from repro_torch.sharding.local import local_shape
from repro_torch.sharding.rules import P, MeshShape
from torch_port import port_cfg

import torch_mesh_workers as workers

TOL = dict(atol=1e-5, rtol=1e-5)
# the first multithreaded torch.exp of a process may take a less exact
# path (tests/test_torch_ssd_scan.py): make it here, before any test
torch.exp(torch.zeros(1 << 17))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ADAMW = dict(lr=3e-2, warmup_steps=2, total_steps=100, eps=1e-3)
B, S = 4, 32
TIMEOUT_S = 240
ARCHS = ("tiny", "mamba2-780m", "granite-moe-3b-a800m", "musicgen-large")
TRAIN_MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
GRAD_CASES = {(1, 2): ("tiny", "mamba2-780m", "granite-moe-3b-a800m"),
              (2, 1): ("tiny", "mamba2-780m", "granite-moe-3b-a800m"),
              (1, 4): ("tiny", "tiny-hd")}


# ----------------------------------------------------------------------
# (i) specs and local shapes against the JAX specs
# ----------------------------------------------------------------------

def _flat(tree, path=""):
    """(path, leaf) pairs of a tree of dicts (sorted keys), tuples and
    lists, with every spec or sharding as a plain tuple."""
    if isinstance(tree, NamedSharding):
        return [(path, tuple(tree.spec))]
    if isinstance(tree, (P, PartitionSpec)):
        return [(path, tuple(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                      f"{path}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _flat(v,
                                                            f"{path}[{i}]")]
    return [(path, tree)]


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(cfg):
    return jax_model.param_shapes(cfg)


@pytest.mark.parametrize("sizes", [(2, 2), (1, 4), (4, 1), (16, 16)])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_and_local_shapes_match_jax(arch, sizes, monkeypatch):
    monkeypatch.setattr(jax_steps, "param_shapes", _jax_param_shapes)
    names = ("data", "model")
    jmesh, mesh = AbstractMesh(sizes, names), MeshShape(sizes, names)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        _, want_args, want_in, want_out = jax_steps.make_step_and_specs(
            jcfg, JAX_SHAPES[name], jmesh)
        _, args, ins, outs = steps.make_step_and_specs(cfg, shape, mesh,
                                                       device="meta")
        assert _flat(ins) == _flat(want_in), (name, "in")
        assert _flat(outs) == _flat(want_out), (name, "out")
        got = _flat(args)
        want = _flat(want_args)
        assert [p for p, _ in got] == [p for p, _ in want], name
        for (path, x), (_, w), (_, spec) in zip(got, want, _flat(ins)):
            assert x.is_meta, (name, path)
            assert tuple(x.shape) == local_shape(w.shape, P(*spec), mesh), \
                (name, path)
            assert str(x.dtype).removeprefix("torch.") == str(w.dtype), \
                (name, path)
        if shape.kind == "train":  # abstract_opt is the opt arg's tree
            opt, ospecs = steps.abstract_opt(cfg, mesh)
            assert _flat(ospecs) == _flat(want_in[1]), name
            assert [(p, tuple(x.shape), x.dtype) for p, x in _flat(opt)] == \
                [(p, tuple(x.shape), x.dtype) for p, x in _flat(args[1])]


# ----------------------------------------------------------------------
# (ii) 1x1: bit for bit the one-device steps
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh1x1():
    mesh = make_serving_mesh(1, 1, device="cpu")
    yield mesh
    close_mesh()


def _reduced(arch):
    if arch == "tiny":
        return tiny_model_config()
    if arch == "tiny-hd":
        return dataclasses.replace(tiny_model_config(), n_heads=2,
                                   n_kv_heads=1)
    return jax_reduced(jax_get_config(arch), d_model=64)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["tiny", "mamba2-780m"])
def test_1x1_steps_are_bit_for_bit_the_one_device_steps(arch, kind,
                                                        mesh1x1):
    cfg = port_cfg(_reduced(arch))
    shape = InputShape(f"x_{kind}", S, 2, kind)
    step, args = steps.make_step_and_inputs(cfg, shape, device="cpu",
                                            dtype=torch.float32)
    mstep, margs, _, _ = steps.make_step_and_specs(
        cfg, shape, mesh1x1, device="cpu", dtype=torch.float32)
    assert torch.equal(margs[0]["embed"]["table"], args[0]["embed"]["table"])
    want = flatten_with_keystr(list(step(*args)))
    got = flatten_with_keystr(list(mstep(*margs)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        assert torch.equal(x, y), path


# ----------------------------------------------------------------------
# (iii)-(v) gloo meshes against the JAX one-device steps
# ----------------------------------------------------------------------

def _batch(cfg, seed, b=B, s=S, with_labels=True):
    """A numpy batch of the step layer's layout; ``loss_mask`` False on
    the prefix and on a random share of each row, so rows differ."""
    meta = steps.make_batch(cfg, b, s, with_labels=with_labels,
                            device="meta")
    rng = np.random.RandomState(seed)
    out = {}
    for k, x in meta.items():
        shape = tuple(x.shape)
        if k == "prefix_embeds":
            out[k] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        elif k == "loss_mask":
            mask = rng.rand(*shape) < rng.uniform(0.3, 0.9, (shape[0], 1))
            if "prefix_embeds" in meta:
                mask[:, :meta["prefix_embeds"].shape[1]] = False
            out[k] = mask
        else:
            out[k] = rng.randint(1, cfg.vocab_size, shape).astype(np.int32)
    if with_labels and "loss_mask" not in out:
        out["loss_mask"] = rng.rand(b, s) < rng.uniform(0.3, 0.9, (b, 1))
    return out


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = _reduced(arch)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    return jcfg, port_cfg(jcfg), jparams, jax.tree.map(np.asarray, jparams)


def _train_case(arch, nm):
    jcfg, cfg, jparams, tree = _model(arch)
    return cfg, tree, _batch(cfg, seed=1), nm, ADAMW


@functools.lru_cache(maxsize=None)
def _jax_train(arch, nm):
    jcfg, cfg, jparams, _ = _model(arch)
    batch = _batch(cfg, seed=1)
    step = jax.jit(jax_train.make_train_step(jcfg, jax_train.TrainConfig(
        adamw=jax_opt.AdamWConfig(**ADAMW), microbatches=nm, remat=True,
        param_dtype=jnp.float32)))
    p, o, m = step(jparams, jax_opt.init_opt_state(jparams),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    return p, o, m


def _serve_cases():
    """{name: (port cfg, kind, seq, params, args)} of (iv)."""
    cases = {}
    for arch in ARCHS:
        jcfg, cfg, _, tree = _model(arch)
        cases[f"{arch} prefill"] = (cfg, "prefill", S, tree,
                                    (_batch(cfg, 2, with_labels=False),))
        for b in ((4, 1) if arch == "tiny" else (4,)):
            caches, tok, pos = _decode_inputs(arch, b)
            cases[f"{arch} decode {b}"] = (cfg, "decode", 32, tree,
                                           (caches, tok, pos))
    return cases


@functools.lru_cache(maxsize=None)
def _decode_inputs(arch, b):
    jcfg, cfg, jparams, _ = _model(arch)
    rng = np.random.RandomState(3)
    hist = rng.randint(1, cfg.vocab_size, (b, 20)).astype(np.int32)
    _, jc = jax_model.prefill(jparams, jcfg, jnp.asarray(hist))
    caches = jax.tree.map(np.asarray, jax_model.cache_from_prefill(jcfg, jc,
                                                                   32))
    tok = rng.randint(1, cfg.vocab_size, (b, 1)).astype(np.int32)
    return caches, tok, np.full(b, 20, np.int32)


@functools.lru_cache(maxsize=None)
def _on_mesh(sizes):
    """Every case of ``sizes`` in one ``run_on_mesh`` call."""
    train = {(arch, 1): _train_case(arch, 1) for arch in ARCHS}
    if sizes == (2, 1):
        train[("tiny", 2)] = _train_case("tiny", 2)
    if sizes == (1, 4):
        train[("tiny-hd", 1)] = _train_case("tiny-hd", 1)
    grads = {arch: (_model(arch)[1], 0, _batch(_model(arch)[1], seed=4))
             for arch in GRAD_CASES.get(sizes, ())}
    serve = _serve_cases() if sizes == (2, 2) else {}
    return run_on_mesh(*sizes, workers.step_layer_on_mesh, train, grads,
                       serve, device="cpu", timeout_s=TIMEOUT_S)


def _close_jax(got, want, what):
    """A gathered numpy tree against a JAX tree, leaf for leaf."""
    g = dict(flatten_with_keystr(got))
    w = [(jax.tree_util.keystr(p), x)
         for p, x in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert set(g) == {p for p, _ in w}, what
    for path, x in w:
        np.testing.assert_allclose(g[path], np.asarray(x, np.float32), **TOL,
                                   err_msg=f"{what} {path}")


TRAIN_CASES = [(sizes, arch, 1) for sizes in TRAIN_MESHES for arch in ARCHS]
TRAIN_CASES += [((2, 1), "tiny", 2), ((1, 4), "tiny-hd", 1)]


@pytest.mark.parametrize("sizes,arch,nm", TRAIN_CASES)
def test_train_step_on_mesh_matches_jax(sizes, arch, nm):
    got = _on_mesh(sizes)["train"][(arch, nm)]
    p, o, m = _jax_train(arch, nm)
    for k in ("loss", "acc", "moe_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], np.asarray(m[k]), **TOL,
                                   err_msg=k)
    _close_jax(got["params"], p, "params")
    for field in ("master", "m", "v"):
        _close_jax(got[field], getattr(o, field), field)


def _serve_names():
    return [f"{arch} prefill" for arch in ARCHS] + \
        [f"{arch} decode 4" for arch in ARCHS] + ["tiny decode 1"]


@pytest.mark.parametrize("name", _serve_names())
def test_prefill_and_decode_on_2x2_match_jax(name):
    got = _on_mesh((2, 2))["serve"][name]
    arch, kind = name.split(" ")[:2]
    jcfg, cfg, jparams, _ = _model(arch)
    _, _, _, _, args = _serve_cases()[name]
    if kind == "prefill":
        batch = args[0]
        logits, caches = jax_model.prefill(
            jparams, jcfg, jnp.asarray(batch["tokens"]),
            prefix_embeds=(jnp.asarray(batch["prefix_embeds"])
                           if "prefix_embeds" in batch else None),
            logits_last_only=True)
        np.testing.assert_allclose(got[0], np.asarray(logits[:, 0]), **TOL)
        _close_jax(got[1], caches, "caches")
    else:
        caches, tok, pos = args
        nxt, out = jax.jit(jax_make_serve_step(jcfg))(
            jparams, caches, jnp.asarray(tok), jnp.asarray(pos))
        np.testing.assert_array_equal(got[0], np.asarray(nxt))
        _close_jax(got[1], out, "caches")


def test_batch_1_decode_on_2x2_holds_one_layer_ring_whole():
    """At batch 1 the ring's slots are cut over ``data``: each layer
    gathers its own, so no more than one layer's whole ring is alive at
    once during the step."""
    most, one_layer = _on_mesh((2, 2))["rings"]["tiny decode 1"]
    assert _model("tiny")[1].n_layers > 1
    assert 0 < most <= one_layer


GRAD_PARAMS = [(sizes, arch) for sizes, archs in GRAD_CASES.items()
               for arch in archs]


@pytest.mark.parametrize("sizes,arch", GRAD_PARAMS)
def test_each_rank_gradient_is_its_block_of_the_one_device_gradient(sizes,
                                                                    arch):
    assert _on_mesh(sizes)["grads"][arch] <= 1e-5


def test_step_layer_on_a_mesh_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b")
    mesh = MeshShape((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.make_step_and_specs(cfg, SHAPES["train_4k"], mesh, batch=2)
