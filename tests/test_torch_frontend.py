"""The port's modality frontend stubs, the one-copy ``init_params`` and the
donating AdamW.

``frontend_prefix_len`` must equal the JAX package's integer for integer
at every assigned arch and input-shape length. The stubs draw from a
``torch.Generator`` (torch's bits), so only their shapes, dtypes, scale
and seeding are checked here; the parity tests feed both packages the
same numpy embeddings (``tests/test_torch_archs.py``).

``init_params`` allocates each stacked (R, ...) leaf once and fills it a
repeat at a time. It must give bit for bit what the list-then-
``torch.stack`` construction it replaced gave, written out here, on
``tiny-test``, the reduced Mamba2 and a reduced MoE config.

The donating train step (``make_train_step(..., donate=True)``, through
``adamw_update_``) writes into the params and optimizer state it is
given; it must be bit for bit the functional step over 3 steps, with 1
and 2 microbatches, in f32 and bf16 params, on ``tiny-test`` and the
reduced Mamba2 (whose f32 SSM leaves come back in the params' dtype, as
from the functional step), and the functional step must leave what it
was given as it was. ``adamw_update_`` and its functional form
``adamw_update`` are both held bit for bit against the whole-leaf AdamW
they replaced, written out here.
"""
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.models import frontend as jax_frontend
from repro_torch.configs import get_config, reduced
from repro_torch.configs.archs import ASSIGNED
from repro_torch.models import frontend
from repro_torch.models.common import (flatten_with_keystr, normal_init,
                                       tree_map)
from repro_torch.models.model import (_init_layer, init_params,
                                      pattern_sig)
from repro_torch.models.norms import init_rmsnorm
from repro_torch.training import optimizer, train_loop
from conftest import tiny_model_config
from torch_port import port_cfg

TINY = port_cfg(tiny_model_config())


def test_constants_match_jax():
    assert frontend.VISION_PATCHES_PER_IMAGE == \
        jax_frontend.VISION_PATCHES_PER_IMAGE
    assert frontend.AUDIO_FRAMES_PER_SECOND == \
        jax_frontend.AUDIO_FRAMES_PER_SECOND


@pytest.mark.parametrize("arch", ASSIGNED + ("itfi-ranker",))
def test_prefix_len_matches_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    lengths = sorted({s.seq_len for s in JAX_SHAPES.values()}
                     | {0, 1, 7, 8, 9, 63, 64, 511, 512, 513, 5759, 5760,
                        5761, 2 * 2880 + 1})
    for s in lengths:
        assert frontend.frontend_prefix_len(cfg, s) == \
            jax_frontend.frontend_prefix_len(jcfg, s), (arch, s)
    assert (frontend.frontend_prefix_len(cfg, 4096) > 0) == \
        (cfg.frontend != "none")


@pytest.mark.parametrize("stub", ["vision_stub_embeds", "audio_stub_embeds"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_stubs(stub, dtype):
    fn = getattr(frontend, stub)
    x = fn(torch.Generator().manual_seed(3), 2, 5, 16, dtype, "cpu")
    assert x.shape == (2, 5, 16) and x.dtype == dtype
    assert x.device.type == "cpu"
    assert 0.005 < float(x.float().std()) < 0.05
    again = fn(torch.Generator().manual_seed(3), 2, 5, 16, dtype, "cpu")
    assert torch.equal(x, again)
    other = fn(torch.Generator().manual_seed(4), 2, 5, 16, dtype, "cpu")
    assert not torch.equal(x, other)
    meta = fn(None, 2, 5, 16, dtype, "meta")
    assert meta.is_meta and meta.shape == (2, 5, 16) and meta.dtype == dtype


def test_encodec_stub_tokens():
    toks = frontend.encodec_stub_tokens(torch.Generator().manual_seed(0), 3,
                                        50, vocab=2048, device="cpu")
    assert toks.shape == (3, 50) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 2048
    assert frontend.encodec_stub_tokens(None, 3, 50, device="meta").is_meta


def test_stub_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for stub in (frontend.vision_stub_embeds, frontend.audio_stub_embeds):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            stub(torch.Generator(), 1, 2, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frontend.encodec_stub_tokens(torch.Generator(), 1, 2)


# ----------------------------------------------------------------------
# init_params: one allocation per stacked leaf, the same bits
# ----------------------------------------------------------------------

def _old_init_params(cfg, generator, dtype, device):
    """The construction ``init_params`` replaced: every repeat's layer
    drawn into a list, the list then stacked."""
    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees])
                for k, v in trees[0].items()}

    pat = pattern_sig(cfg)
    R = cfg.n_layers // len(pat)
    blocks = {f"pos{p}": stack([_init_layer(generator, cfg, kind, mlp_kind,
                                            dtype, device)
                                for _ in range(R)])
              for p, (kind, mlp_kind) in enumerate(pat)}
    params = {
        "embed": {"table": normal_init(generator,
                                       (cfg.vocab_padded, cfg.d_model),
                                       cfg.d_model ** -0.5, dtype, device)},
        "blocks": blocks,
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": normal_init(
            generator, (cfg.vocab_padded, cfg.d_model), cfg.d_model ** -0.5,
            dtype, device)}
    return params


def _init_configs():
    return {"tiny-test": TINY,
            "mamba2-reduced": reduced(get_config("mamba2-780m")),
            "moe-reduced": reduced(get_config("granite-moe-3b-a800m"),
                                   n_layers=4, d_model=64),
            "hybrid-reduced": reduced(get_config("jamba-v0.1-52b"),
                                      n_layers=4, d_model=64)}


@pytest.mark.parametrize("name", ["tiny-test", "mamba2-reduced",
                                  "moe-reduced", "hybrid-reduced"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_bit_equal_to_stacked_list(name, dtype):
    cfg = _init_configs()[name]
    got = init_params(cfg, torch.Generator().manual_seed(7), dtype, "cpu")
    want = _old_init_params(cfg, torch.Generator().manual_seed(7), dtype,
                            "cpu")
    g, w = flatten_with_keystr(got), flatten_with_keystr(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype, path
        assert a.is_contiguous(), path
        assert torch.equal(a, b), path


def test_init_params_meta_allocates_nothing():
    cfg = get_config("llava-next-34b")
    params = init_params(cfg, torch.Generator(), torch.bfloat16, "meta")
    leaves = [t for _, t in flatten_with_keystr(params)]
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == cfg.param_count()


# ----------------------------------------------------------------------
# The donating AdamW and train step
# ----------------------------------------------------------------------

def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _equal_trees(a, b):
    fa, fb = flatten_with_keystr(a), flatten_with_keystr(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def _batches(cfg, n, b=4, s=12, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        toks = rng.randint(1, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["tiny-test", "mamba2-reduced"])
def test_donating_step_bit_equal_to_functional(name, microbatches, dtype):
    cfg = _init_configs()[name]
    params = init_params(cfg, torch.Generator().manual_seed(1), dtype, "cpu")
    tcfg = train_loop.TrainConfig(
        adamw=optimizer.AdamWConfig(lr=1e-2, warmup_steps=1,
                                    total_steps=5),
        microbatches=microbatches, remat=True, param_dtype=dtype)
    fstep = train_loop.make_train_step(cfg, tcfg)
    dstep = train_loop.make_train_step(cfg, tcfg, donate=True)
    fp, fo = params, optimizer.init_opt_state(params)
    dp, do = _clone(params), optimizer.init_opt_state(params)
    leaf = dp["embed"]["table"]
    kept = (_clone(fp), _clone(fo.master), _clone(fo.m), _clone(fo.v))
    given = (fp, fo.master, fo.m, fo.v)
    for batch in _batches(cfg, 3):
        fp, fo, fm = fstep(fp, fo, batch)
        dp, do, dm = dstep(dp, do, batch)
        for k in fm:
            assert torch.equal(fm[k], dm[k]), k
        _equal_trees(dp, fp)
        for name in ("master", "m", "v"):
            _equal_trees(getattr(do, name), getattr(fo, name))
        assert int(do.step) == int(fo.step)
    # the donated tensors are the ones updated; the functional step's
    # first inputs are as they were
    assert dp["embed"]["table"] is leaf
    assert not torch.equal(leaf, params["embed"]["table"])
    for a, b in zip(given, kept):
        _equal_trees(a, b)


def _adamw_whole_leaf(cfg, grads, opt, param_dtype):
    """The functional AdamW as it was written before the in-place form:
    whole-leaf f32 operations into new tensors."""
    gnorm, clip, step, lr, b1c, b2c = optimizer._step_scalars(cfg, grads,
                                                             opt)
    params, master, m_t, v_t = {}, {}, {}, {}
    for path in optimizer._paths(grads):
        g = optimizer._get(grads, path).to(torch.float32) * clip
        p32 = optimizer._get(opt.master, path)
        m = cfg.b1 * optimizer._get(opt.m, path) + (1 - cfg.b1) * g
        v = cfg.b2 * optimizer._get(opt.v, path) + (1 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if optimizer._is_matrix(path):
            delta = delta + cfg.weight_decay * p32
        new = p32 - lr * delta
        for tree, x in ((master, new), (m_t, m), (v_t, v),
                        (params, new.to(param_dtype))):
            optimizer._put(tree, path, x)
    return params, optimizer.OptState(step, master, m_t, v_t), {
        "grad_norm": gnorm, "lr": lr}


def test_adamw_update_inplace_in_pieces(monkeypatch):
    """``adamw_update_`` on bf16 grads, cut into pieces of a few rows (a
    small ``_PIECE``), and ``adamw_update`` on the f32 grads, against the
    whole-leaf AdamW; the grads tree is emptied leaf by leaf, and the
    functional form leaves its grads and optimizer state as they were."""
    monkeypatch.setattr(optimizer, "_PIECE", 7)
    g = torch.Generator().manual_seed(2)
    params = {"blocks": {"w": torch.randn((5, 3, 4), generator=g),
                         "scale": torch.randn((5, 4), generator=g)},
              "embed": {"table": torch.randn((9, 4), generator=g)}}
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    opt = optimizer.init_opt_state(params)
    rp, ro = params, opt
    fo = opt
    dp = _clone(params)
    do = optimizer.OptState(opt.step.clone(), _clone(opt.master),
                            _clone(opt.m), _clone(opt.v))
    for i in range(3):
        grads = tree_map(lambda t: torch.randn(t.shape, generator=g).to(
            torch.bfloat16) * (i + 1), params)
        g32 = tree_map(lambda t: t.to(torch.float32), grads)
        rp, ro, rs = _adamw_whole_leaf(cfg, g32, ro, torch.bfloat16)
        kept = (_clone(g32), _clone(fo.master), _clone(fo.m), _clone(fo.v))
        given = (g32, fo.master, fo.m, fo.v)
        fp, fo, fs = optimizer.adamw_update(cfg, g32, fo)
        for a, b in zip(given, kept):
            _equal_trees(a, b)
        dgrads = _clone(grads)
        dp, do, ds = optimizer.adamw_update_(cfg, dgrads, do, dp)
        assert dgrads == {"blocks": {}, "embed": {}}
        for stats in (fs, ds):
            assert torch.equal(rs["grad_norm"], stats["grad_norm"])
            assert torch.equal(rs["lr"], stats["lr"])
        for p_, o_ in ((fp, fo), (dp, do)):
            _equal_trees(p_, rp)
            assert int(o_.step) == int(ro.step)
            for name in ("master", "m", "v"):
                _equal_trees(getattr(o_, name), getattr(ro, name))
    # a leaf of another dtype is replaced by one of param_dtype
    dp["blocks"]["scale"] = dp["blocks"]["scale"].float()
    rp, ro, _ = _adamw_whole_leaf(
        cfg, tree_map(lambda t: t.to(torch.float32), grads), ro,
        torch.bfloat16)
    dp, do, _ = optimizer.adamw_update_(cfg, _clone(grads), do, dp)
    assert dp["blocks"]["scale"].dtype == torch.bfloat16
    _equal_trees(dp, rp)
