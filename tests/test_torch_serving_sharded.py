"""The port's sharded serving path on the CPU: gloo processes as the mesh.

- ``init_params(..., mesh=)`` on every rank of 2x2 and 1x4 meshes gives,
  bit for bit, the blocks of the unsharded init; ``params_from_numpy``
  and ``shard_tree`` cut carried JAX weights the same way;
- a 1x1 mesh's Gateway is the mesh-free Gateway bit for bit, from the
  host LRU and from the pool (every collective is an identity there);
- reduced ``jamba-v0.1-52b`` and ``granite-moe-3b-a800m`` engines at 1x2
  (expert parallelism, MoE d_ff inside each expert, the SSM's heads and
  its gated-norm all-reduce) within 1e-4 of one device with equal slates;
- ``apply_patch`` and sampled decode on a 2x2 mesh;
- the port's Gateway on a 2x2 mesh against the JAX package's one-device
  Gateway on the JAX equivalence tool's trace, from carried fp32 weights:
  equal slates, hits and rollover telemetry, scores within 2e-3.

The equivalence tool itself runs at 4x1, 2x2, 1x4 and pooled in
``test_torch_mesh_equiv.py``. Every mesh is at most four processes, each
with one thread; a collective that a rank never joins fails after
gloo's timeout.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models.model import init_params
from repro_torch.sharding.local import local_shard, shard_tree
from repro_torch.sharding.rules import serving_param_pspecs
from repro_torch.weights import params_from_numpy
from torch_port import port_cfg

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import torch_sharded_equiv_check as tool  # noqa: E402


class Coords:
    """A rank's place on a ("data", "model") mesh, without a process
    group: what the shard functions read of a ``DeviceMesh``."""

    def __init__(self, data, model, rank_data, rank_model):
        self.mesh_dim_names = ("data", "model")
        self._sizes = (data, model)
        self._coords = {"data": rank_data, "model": rank_model}

    def size(self, i):
        return self._sizes[i]

    def get_local_rank(self, axis):
        return self._coords[axis]


def _ranks(data, model):
    return [Coords(data, model, d, m) for d in range(data)
            for m in range(model)]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _spec_leaves(tree):
    """{path: spec} of a spec tree (a ``P`` is a tuple, not a dict)."""
    return dict(_leaves(tree))


ARCHS = ("itfi-ranker", "jamba-v0.1-52b", "granite-moe-3b-a800m",
         "mamba2-780m", "mixtral-8x22b")


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_is_the_slice_of_init(arch, shape):
    cfg = reduced(get_config(arch))
    full = init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16,
                       "cpu")
    cut = 0
    for rank in _ranks(*shape):
        specs = _spec_leaves(serving_param_pspecs(cfg, rank))
        got = dict(_leaves(init_params(cfg, torch.Generator().manual_seed(7),
                                       torch.bfloat16, "cpu", mesh=rank)))
        for path, leaf in _leaves(full):
            want = local_shard(leaf, specs[path], rank)
            assert got[path].dtype == want.dtype, path
            assert torch.equal(got[path], want), path
            cut += got[path].numel() < leaf.numel()
    assert cut > 0  # the layout cuts something at this mesh


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_carried_jax_weights_shard(shape):
    from repro.configs.base import get_config as jget, reduced as jreduced
    from repro.models.model import init_params as jinit

    jcfg = jreduced(jget("jamba-v0.1-52b"))
    cfg = port_cfg(jcfg)
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32))
    full = params_from_numpy(tree, cfg, "cpu")
    for rank in _ranks(*shape):
        specs = serving_param_pspecs(cfg, rank)
        got = params_from_numpy(tree, cfg, "cpu", mesh=rank)
        cut = shard_tree(full, specs, rank)
        flat = _spec_leaves(specs)
        for (path, a), (_, b) in zip(_leaves(got), _leaves(cut)):
            assert torch.equal(a, b), path
            assert torch.equal(a, local_shard(dict(_leaves(full))[path],
                                              flat[path], rank)), path


@pytest.mark.parametrize("pool", [None, 16], ids=["lru", "pool"])
def test_mesh_1x1_gateway_bitwise_equals_mesh_free(pool):
    got = run_on_mesh(1, 1, workers.mesh_1x1_bitwise, pool, device="cpu")
    assert got == {"slates": True, "scores": True, "counters": True,
                   "rollover": True}


def test_reduced_moe_and_hybrid_engines_at_1x2():
    cfgs = {"jamba": reduced(get_config("jamba-v0.1-52b")),
            "granite": reduced(get_config("granite-moe-3b-a800m")),
            # three experts do not divide 2: d_ff inside each expert
            "granite-3e": reduced(get_config("granite-moe-3b-a800m"),
                                  max_experts=3)}
    got = run_on_mesh(1, 2, workers.engines_match, cfgs, device="cpu")
    for name, res in got.items():
        assert res["slates"], name
        assert res["max_abs"] < 1e-4, (name, res)


def test_apply_patch_and_sampling_on_a_2x2_mesh():
    got = run_on_mesh(2, 2, workers.patch_on_mesh, device="cpu")
    assert got["counts"] == (3, 3)
    assert got["slates"] and got["max_abs"] < 1e-4, got
    for plain, sharded in got["messages"]:
        assert plain is not None and plain == sharded
    drawn = run_on_mesh(2, 2, workers.sampled_on_mesh, device="cpu")
    np.testing.assert_array_equal(drawn["plain"], drawn["sharded"])


def test_sharded_port_gateway_matches_jax_one_device_gateway():
    """The JAX tool's trace: the JAX package's Gateway on one device
    against the port's on a 2x2 gloo mesh, both from the same fp32
    weights."""
    import repro.configs.base as jbase
    from repro.core import feature_store, injection, realtime
    from repro.models.model import init_params as jinit
    from repro.serving import scheduler
    from repro.serving.api import Request
    from repro.serving.engine import ServingConfig, ServingEngine

    jcfg = tool.model_config(jbase)
    jparams = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    eng = ServingEngine(jcfg, jparams, ServingConfig(
        max_batch=8, prefill_len=32, inject_len=8, cache_capacity=64))
    want = tool.trace(tool.build_gateway(eng, feature_store, realtime,
                                         injection, scheduler), Request)
    got = run_on_mesh(2, 2, tool.port_record,
                      jax.tree.map(np.asarray, jparams), None, "cpu",
                      device="cpu")
    tool.compare(want, got, "JAX 1 device vs port 2x2", data_shards=2)
