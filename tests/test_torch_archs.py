"""Every assigned architecture on the port against the JAX package
(the port's counterpart of ``tests/test_arch_smoke.py``).

For each arch of ``ASSIGNED`` (and the paper's ranker): the registered
config equals the JAX one field by field (the MoE and SSM sub-configs
included), and so do its total and active parameter counts. At reduced
size (2 layers, d_model 64, at most 4 experts, vocab 512; JAX
``init_params`` weights carried over in fp32, TF32 off) a forward pass,
one serve step (prefill, the ring cache, a decode step) and, in
``tests/test_torch_archs_train.py``, one train step agree with the JAX
package within 1e-5. ``musicgen-large`` and ``llava-next-34b`` take the
embeddings of a modality frontend in front of their tokens: both packages
get the same numpy prefix embeddings (4 positions, as
``tests/test_arch_smoke.py`` gives them) through forward, prefill and the
train step, whose labels cover the prefix positions with ``loss_mask``
False there.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ASSIGNED as JAX_ASSIGNED
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import model as jax_model
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.archs import ASSIGNED
from repro_torch.models.model import (cache_from_prefill, decode_step,
                                      forward, prefill)
from repro_torch.weights import params_from_numpy
from torch_port import port_cfg

TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 16
PREFIX = 4      # frontend positions, as tests/test_arch_smoke.py's _prefix
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def test_assigned_and_registry_match_jax():
    assert ASSIGNED == JAX_ASSIGNED
    assert set(list_configs()) == set(ASSIGNED) | {"itfi-ranker"}


@pytest.mark.parametrize("arch", ASSIGNED + ("itfi-ranker",))
def test_registered_config_matches_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.layer_kinds() == jcfg.layer_kinds()
    assert cfg.mlp_kinds() == jcfg.mlp_kinds()


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jax_reduced(jax_get_config(arch), d_model=64)
    cfg = port_cfg(jcfg)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)


def _prefix(cfg, seed, n=PREFIX):
    """Frontend embeddings (B, n, d_model) f32 for a vision or audio arch,
    the stubs' scale (0.02 N(0, 1)) from numpy; None for the others."""
    if cfg.frontend == "none":
        return None
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, n, cfg.d_model)) * 0.02).astype(
        np.float32)


def _prefix_kw(pfx, to):
    return {} if pfx is None else {"prefix_embeds": to(pfx)}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_reduced_forward_matches_jax(arch):
    jcfg, jparams, cfg, params = _setup(arch)
    toks = _tokens(cfg, 1)[:, :S]
    pfx = _prefix(cfg, 11)
    want, _ = jax.jit(jax_model.forward, static_argnums=1)(
        jparams, jcfg, jnp.asarray(toks), **_prefix_kw(pfx, jnp.asarray))
    got = forward(params, cfg, torch.from_numpy(toks),
                  **_prefix_kw(pfx, torch.from_numpy))
    n_pfx = 0 if pfx is None else PREFIX
    assert got.shape == (B, n_pfx + S, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_reduced_serve_step_matches_jax(arch):
    """prefill (after the prefix embeddings of a frontend arch), its ring
    cache and one decode step."""
    jcfg, jparams, cfg, params = _setup(arch)
    toks = _tokens(cfg, 3)
    pfx = _prefix(cfg, 13)
    wlog, jc = jax.jit(jax_model.prefill, static_argnums=1)(
        jparams, jcfg, jnp.asarray(toks[:, :S]),
        **_prefix_kw(pfx, jnp.asarray))
    log, c = prefill(params, cfg, torch.from_numpy(toks[:, :S]),
                     **_prefix_kw(pfx, torch.from_numpy))
    np.testing.assert_allclose(log.numpy(), np.asarray(wlog), **TOL)
    jdc = jax_model.cache_from_prefill(jcfg, jc, 64)
    dc = cache_from_prefill(cfg, c, 64)
    pos = np.full(B, S + (0 if pfx is None else PREFIX), np.int32)
    want, _ = jax.jit(jax_model.decode_step, static_argnums=1)(
        jparams, jcfg, jdc, jnp.asarray(toks[:, S:]), jnp.asarray(pos))
    got, _ = decode_step(params, cfg, dc, torch.from_numpy(toks[:, S:]),
                         torch.from_numpy(pos))
    assert got.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
