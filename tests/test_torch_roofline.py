"""The port's roofline (``launch/roofline.py``) against the JAX package's
``launch/roofline.py`` and hand-worked cases.

(i) ``model_flops`` equals the JAX one, bit for bit, for every assigned
    arch x input shape.
(ii) The ring factors of each collective kind, on hand-worked cases and
    against the JAX ``hlo_analysis._wire_bytes``.
(iii) Which groups run over NVLink: a group of ranks inside one node of 8
    consecutive ranks, the model axis fastest.
(iv) ``roofline_terms`` on a hand-made ``OpCost``: each term, the
    dominant one and the JAX keys that keep a meaning.
(v) The H100 constants are the datasheet's.
"""
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.launch import hlo_analysis as jax_hlo
from repro.launch import roofline as jax_roofline
from repro_torch.configs import get_config
from repro_torch.configs.archs import ASSIGNED
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.op_analysis import OpCost, wire_bytes
from repro_torch.launch.roofline import (in_one_node, model_flops,
                                         roofline_terms)
from repro_torch.sharding.rules import MeshShape


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        got = model_flops(cfg, shape)
        want = jax_roofline.model_flops(jcfg, JAX_SHAPES[name])
        assert got == want and type(got) is type(want), (name, got, want)


# (kind, result bytes, group size, wire bytes a device, worked by hand)
RING_CASES = [
    ("all-gather", 1024, 4, 768.0),           # 1024 x 3/4
    ("reduce-scatter", 256, 4, 768.0),        # 256 x 3
    ("all-reduce", 1000, 4, 1500.0),          # 1000 x 2 x 3/4
    ("all-to-all", 1024, 4, 768.0),           # 1024 x 3/4
    ("collective-permute", 100, 2, 100.0),    # the result once
    ("all-reduce", 4096, 16, 7680.0),         # 4096 x 2 x 15/16
    ("all-gather", 512, 2, 256.0),            # 512 x 1/2
]


@pytest.mark.parametrize("kind,out,group,want", RING_CASES)
def test_ring_factors(kind, out, group, want):
    assert wire_bytes(kind, out, group) == want
    assert wire_bytes(kind, out, group) == jax_hlo._wire_bytes(kind, out,
                                                               group)


@pytest.mark.parametrize("sizes,axes,want", [
    ({"data": 1, "model": 4}, ("model",), True),     # the four cards
    ({"data": 4, "model": 1}, ("data",), True),
    ({"data": 2, "model": 4}, ("data",), True),      # ranks r, r + 4
    ({"data": 2, "model": 4}, ("data", "model"), True),
    ({"data": 4, "model": 4}, ("data",), False),     # ranks r .. r + 12
    ({"data": 4, "model": 4}, ("model",), True),
    ({"data": 16, "model": 16}, ("model",), False),  # 16 ranks a group
    ({"data": 16, "model": 16}, ("data",), False),
    ({"data": 3, "model": 3}, ("model",), False),    # {6, 7, 8} crosses
    ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"), False),
])
def test_groups_in_one_node(sizes, axes, want):
    assert in_one_node(sizes, axes) is want


def test_roofline_terms_by_hand():
    cfg, shape = get_config("llama3.2-1b"), SHAPES["decode_32k"]
    mesh = MeshShape((16, 16), ("data", "model"))
    chips = 256
    mf = model_flops(cfg, shape)
    cost = OpCost(flops=mf / chips / 2, bytes_accessed=6.7e8,
                  collectives=[("all-reduce", ("model",), 16, 1 << 20),
                               ("all-gather", ("data",), 16, 1 << 24)],
                  collective_counts={"all-reduce": 1, "all-gather": 1},
                  collective_bytes={"all-reduce": 2 * 15 / 16 * (1 << 20),
                                    "all-gather": 15 / 16 * (1 << 24)})
    cost.wire_bytes = sum(cost.collective_bytes.values())
    t = roofline_terms(cost, chips, cfg, shape, mesh)
    # the compute term takes the larger of the count and MODEL_FLOPS/chips
    assert t["compute_s"] == mf / chips / 989.4e12
    assert t["memory_s"] == 6.7e8 / 3.35e12
    # both groups span 16 ranks, more than a node: the network's rate
    want = (2 * 15 / 16 * (1 << 20) + 15 / 16 * (1 << 24)) / 50e9
    assert t["collective_s"] == pytest.approx(want, rel=1e-12)
    assert t["dominant"] == "collective"
    assert t["model_flops"] == mf and t["chips"] == chips
    assert t["useful_flops_ratio"] == pytest.approx(2.0)
    assert t["collective_counts"] == cost.collective_counts
    assert t["collective_bytes_by_kind"] == cost.collective_bytes
    assert t["collective_wire_bytes_per_device"] == cost.wire_bytes
    jax_keys = {"compute_s", "memory_s", "collective_s", "dominant",
                "model_flops", "useful_flops_ratio", "collective_counts",
                "collective_bytes_by_kind",
                "collective_wire_bytes_per_device", "chips"}
    assert set(t) == jax_keys
    # on four cards of one node the same model-axis collective is NVLink's
    one_node = roofline_terms(
        OpCost(collectives=[("all-reduce", ("model",), 4, 1 << 20)]), 4,
        cfg, shape, MeshShape((1, 4), ("data", "model")))
    assert one_node["collective_s"] == 2 * 3 / 4 * (1 << 20) / 450e9


def test_h100_constants():
    assert tmesh.PEAK_FLOPS_BF16 == 989.4e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.NVLINK_BW == 450e9
    assert tmesh.NET_BW == 50e9
    assert tmesh.HBM_BYTES == 80e9
    assert tmesh.NODE_GPUS == 8
    # no card here: the datasheet's memory
    assert tmesh.hbm_bytes() == 80e9
    for name in ("ICI_BW_PER_LINK", "ICI_LINKS"):
        assert not hasattr(tmesh, name)
