"""One train step of every assigned architecture at reduced size, the
port's ``make_train_step`` against the JAX one (``tests/test_torch_archs.py``
holds the configs, the forward pass and the serve step; the two files
share its set-up). A frontend arch's batch puts the same numpy prefix
embeddings in front of the tokens, with labels over prefix + tokens and
``loss_mask`` False on the prefix positions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_train
from repro_torch.configs.archs import ASSIGNED
from repro_torch.training import optimizer, train_loop
from test_torch_archs import PREFIX, TOL, _prefix, _setup, _tokens


@pytest.mark.parametrize("arch", ASSIGNED)
def test_reduced_train_step_matches_jax(arch):
    """One step from the same weights: loss, accuracy, grad norm and the
    MoE aux, then every updated param (AdamW eps 1e-3, as
    tests/test_torch_training.py says why)."""
    jcfg, jparams, cfg, params = _setup(arch)
    toks = _tokens(cfg, 2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    pfx = _prefix(cfg, 17)
    if pfx is not None:
        b = toks.shape[0]
        batch["prefix_embeds"] = pfx
        batch["labels"] = np.concatenate(
            [np.zeros((b, PREFIX), np.int32), toks[:, 1:]], axis=1)
        mask = np.ones(batch["labels"].shape, bool)
        mask[:, :PREFIX] = False
        batch["loss_mask"] = mask
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
    jstep = jax.jit(jax_train.make_train_step(jcfg, jax_train.TrainConfig(
        adamw=jax_opt.AdamWConfig(**kw), remat=True,
        param_dtype=jnp.float32)))
    tstep = train_loop.make_train_step(cfg, train_loop.TrainConfig(
        adamw=optimizer.AdamWConfig(**kw), remat=True,
        param_dtype=torch.float32))
    jp, _, jm = jstep(jparams, jax_opt.init_opt_state(jparams),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    tp, _, tm = tstep(params, optimizer.init_opt_state(params), batch)
    for name in ("loss", "acc", "grad_norm", "moe_aux"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   **TOL)
    assert (float(tm["moe_aux"]) > 0) == (cfg.moe is not None
                                           and cfg.family != "ssm")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    for path, w in want:
        np.testing.assert_allclose(got[path], np.asarray(w), **TOL)
