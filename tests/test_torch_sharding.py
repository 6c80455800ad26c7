"""The port's sharding rules (``repro_torch.sharding.rules``) against the JAX
package's (``repro.sharding.rules``), spec for spec.

Every assigned arch, ``itfi-ranker`` and the equivalence tool's tiny model,
on abstract meshes of the production shapes (16x16, 2x16x16) and of the
serving meshes the port runs (8x1, 4x1, 2x2, 1x4, 1x1). A JAX
``PartitionSpec`` compares as ``tuple(spec)``; the port's ``P`` is a tuple.
Each case checks ``param_pspecs`` (decode off and on), ``cache_pspecs`` at
batch 128 and 1, ``seq_cache_pspecs``, ``slot_pool_pspecs``,
``serving_pspecs`` and its ``ValueError``, ``head_pspec``, ``batch_pspec``,
``data_axes``, ``opt_pspecs`` and the ``ShardingRules`` fields.
"""
import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs.archs import ASSIGNED
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_config as jax_get_config
from repro.launch.mesh import MULTI_POD, SINGLE_POD
from repro.sharding import rules as jrules
from repro_torch.launch.mesh import MULTI_POD as T_MULTI_POD
from repro_torch.launch.mesh import SINGLE_POD as T_SINGLE_POD
from repro_torch.launch.mesh import n_chips
from repro_torch.sharding import rules
from torch_port import port_cfg

# the JAX equivalence tool's model (tools/sharded_equiv_check.py)
EQUIV = JaxModelConfig(name="equiv-test", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab_size=300 + 256, rope_theta=1e4,
                       tie_embeddings=True)
ARCHS = tuple(ASSIGNED) + ("itfi-ranker", "equiv-test")
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((8, 1), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((1, 1), ("data", "model")))


def _jcfg(arch):
    return EQUIV if arch == "equiv-test" else jax_get_config(arch)


def _jax(tree):
    """A JAX spec tree with every ``PartitionSpec`` as a plain tuple."""
    return jax.tree.map(tuple, tree,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))


def _port(tree):
    return rules.tree_map_specs(tuple, tree)


def test_mesh_constants_match():
    assert (T_SINGLE_POD, T_MULTI_POD) == (SINGLE_POD, MULTI_POD)
    assert (n_chips(), n_chips(True)) == (256, 512)


@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_jax(arch, sizes, names):
    jcfg = _jcfg(arch)
    cfg = port_cfg(jcfg)
    jmesh = AbstractMesh(sizes, names)
    mesh = rules.MeshShape(sizes, names)

    assert rules.data_axes(mesh) == jrules.data_axes(jmesh)
    for decode in (False, True):
        jr = jrules.ShardingRules.make(jcfg, jmesh, decode=decode)
        r = rules.ShardingRules.make(cfg, mesh, decode=decode)
        for field in ("dp", "tp", "dp_size", "tp_size", "attn_heads_on_tp",
                      "moe_experts_on_tp"):
            assert getattr(r, field) == getattr(jr, field), (field, decode)
        assert _port(rules.param_pspecs(cfg, mesh, decode=decode)) == \
            _jax(jrules.param_pspecs(jcfg, jmesh, decode=decode))
    for batch in (128, 1):
        assert _port(rules.cache_pspecs(cfg, mesh, batch)) == \
            _jax(jrules.cache_pspecs(jcfg, jmesh, batch))
        assert tuple(rules.batch_pspec(mesh, batch)) == \
            tuple(jrules.batch_pspec(jmesh, batch))
        assert _port(rules.seq_cache_pspecs(cfg, mesh, batch)) == \
            _jax(jrules.seq_cache_pspecs(jcfg, jmesh, batch))
    assert tuple(rules.head_pspec(cfg, mesh)) == \
        tuple(jrules.head_pspec(jcfg, jmesh))

    jpool = jrules.slot_pool_pspecs(jcfg, jmesh)
    pool = rules.slot_pool_pspecs(cfg, mesh)
    assert _port(pool.caches) == _jax(jpool.caches)
    for field in ("valid", "rows", "logits"):
        assert tuple(getattr(pool, field)) == tuple(getattr(jpool, field))

    dpn = jrules.axis_size(jmesh, jrules.data_axes(jmesh))
    assert rules.axis_size(mesh, rules.data_axes(mesh)) == dpn
    jsp = jrules.serving_pspecs(jcfg, jmesh, 2 * dpn)
    sp = rules.serving_pspecs(cfg, mesh, 2 * dpn)
    assert _port(sp.params) == _jax(jsp.params)
    assert _port(rules.serving_param_pspecs(cfg, mesh)) == _jax(jsp.params)
    for field in ("tokens", "rows", "logits"):
        assert tuple(getattr(sp, field)) == tuple(getattr(jsp, field))
    assert _port(sp.seq_caches) == _jax(jsp.seq_caches)
    assert _port(sp.ring_caches) == _jax(jsp.ring_caches)
    assert sp.data_shards == jsp.data_shards == dpn
    if dpn > 1:
        with pytest.raises(ValueError) as want:
            jrules.serving_pspecs(jcfg, jmesh, dpn + 1)
        with pytest.raises(ValueError) as got:
            rules.serving_pspecs(cfg, mesh, dpn + 1)
        assert str(got.value) == str(want.value)

    jopt = jrules.opt_pspecs(jrules.param_pspecs(jcfg, jmesh))
    opt = rules.opt_pspecs(rules.param_pspecs(cfg, mesh))
    assert tuple(opt.step) == tuple(jopt.step)
    for field in ("master", "m", "v"):
        assert _port(getattr(opt, field)) == _jax(getattr(jopt, field))


def test_p_normalises_as_partition_spec():
    for entries in [(("data",), None), ((), None), (("pod", "data"), None),
                    ("model", None, ("data",)), ()]:
        assert tuple(rules.P(*entries)) == tuple(PartitionSpec(*entries))
