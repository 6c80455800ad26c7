"""The port's dry run (``launch/dryrun.py``) and its analysis
(``launch/op_analysis.py``, the counterpart of the JAX package's
``launch/hlo_analysis.py``).

(i) At 1x1 the meta step's FLOPs equal the JAX ``hlo_analysis`` dot
    FLOPs of the same step compiled on a 1x1 ``make_serving_mesh``: the
    train, prefill and decode steps of ``tiny-test`` and the reduced
    ``llama3.2-1b``, ``granite-moe-3b-a800m`` and ``mamba2-780m`` at seq
    64, batch 2. One op differs, named where it does.
(ii) On a 2x2 gloo mesh a real run of the reduced llama's three steps
    records, rank for rank, the collectives and FLOPs of the meta run on
    ``MeshShape((2, 2))``, entry for entry.
(iii) The kernels' meta routes: empty outputs of the kernel's shapes,
    nothing else allocated, the plain version's FLOPs and the kernel's
    traffic reported; a CPU tensor still takes the plain version.
(iv) The live-bytes count on a hand-written toy step, exactly.
(v) ``run_one`` and the CLI (in one subprocess) write the keys that
    ``benchmarks/run.py::bench_roofline`` reads: ``deepseek-67b``
    ``decode_32k`` on the pod, ``mixtral-8x22b`` ``prefill_32k`` at
    ``--mesh 1,4`` and ``llama3.2-1b`` ``long_500k`` on two pods.

``repro.launch.dryrun`` is never imported here: it sets ``XLA_FLAGS`` for
512 host devices at import, which ``conftest.py`` checks never leaks.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_model_config
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.configs.shapes import InputShape as JaxInputShape
from repro.launch import hlo_analysis
from repro.launch import steps as jax_steps
from repro.launch.mesh import make_serving_mesh as jax_serving_mesh
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.history_merge.ops import history_merge
from repro_torch.kernels.history_merge.ref import history_merge_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.launch.steps import make_step_and_specs
from repro_torch.sharding.local import all_gather, all_reduce
from repro_torch.sharding.rules import MeshShape
from torch_port import port_cfg

import torch_mesh_workers as workers

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH = 64, 2
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
ARCHS = ("tiny", "llama3.2-1b", "granite-moe-3b-a800m", "mamba2-780m")
ONE = MeshShape((1, 1), ("data", "model"))
CLI = ("--arch", "deepseek-67b", "--shape", "decode_32k")


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The CLI's subprocess, ``tools/torch_slot_pool_check.py``'s and the
    2x2 gloo mesh's processes, started first: they run while this
    module's other tests do, and their own tests wait for them."""
    out_dir = tmp_path_factory.mktemp("dryrun_cli")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, *argv], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, argv in (
            ("cli", ("-m", "repro_torch.launch.dryrun", *CLI, "--out",
                     str(out_dir))),
            ("slot_pool", (str(ROOT / "tools" / "torch_slot_pool_check.py"),
                           )))}
    cfg = port_cfg(jax_reduced(jax_get_config("llama3.2-1b")))
    with ThreadPoolExecutor(1) as pool:
        mesh = pool.submit(run_on_mesh, 2, 2, workers.analysis_on_mesh, cfg,
                           SEQ, BATCH, device="cpu", timeout_s=240)
        try:
            yield {"cli": (procs["cli"], out_dir),
                   "slot_pool": procs["slot_pool"], "mesh": (mesh, cfg)}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.communicate()


def _jax_cfg(arch):
    return (tiny_model_config() if arch == "tiny"
            else jax_reduced(jax_get_config(arch)))


def _meta_cost(cfg, kind, mesh=ONE, dtype=torch.bfloat16):
    step, args, _, _ = make_step_and_specs(
        cfg, InputShape(KINDS[kind], SEQ, BATCH, kind), mesh, device="meta",
        dtype=dtype)
    return analyze(step, args)[1]


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_serving_mesh(1, 1)


def _jax_flops(jcfg, kind, mesh):
    step, args, ins, outs = jax_steps.make_step_and_specs(
        jcfg, JaxInputShape(KINDS[kind], SEQ, BATCH, kind), mesh)
    donate = {"train": (0, 1), "decode": (1,), "prefill": ()}[kind]
    compiled = jax.jit(step, in_shardings=ins, out_shardings=outs,
                       donate_argnums=donate).lower(*args).compile()
    return hlo_analysis.analyze(compiled.as_text()).flops


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_jax_hlo_analysis(arch, kind, jax_mesh):
    jcfg = _jax_cfg(arch)
    cfg = port_cfg(jcfg)
    got = _meta_cost(cfg, kind).flops
    want = _jax_flops(jcfg, kind, jax_mesh)
    if arch == "mamba2-780m" and kind == "train":
        # XLA counts as dots the backward of the SSD einsums' products
        # with their (b, nc, Q, nh) operands (dt and its decays), a dot
        # contracting hp (= ds here) each, four a layer: 2·B·S·nh·hp
        # FLOPs each. Torch's einsum backward computes them as multiply
        # and sum, which are no matrix products.
        assert cfg.ssm.head_dim == cfg.ssm.d_state
        dots = 4 * cfg.n_layers * 2 * BATCH * SEQ * cfg.n_ssm_heads \
            * cfg.ssm.head_dim
        assert want - got == dots, (got, want)
    else:
        assert got == want, (got, want)


def test_collectives_equal_a_real_2x2_mesh(background):
    future, cfg = background["mesh"]
    real = future.result(timeout=300)
    mesh = MeshShape((2, 2), ("data", "model"))
    for kind in KINDS:
        cost = _meta_cost(cfg, kind, mesh, torch.float32)
        flops, records = real[kind]
        assert [list(c) for c in cost.collectives] == records, kind
        assert cost.flops == flops and records, kind
    assert {c[0] for c in real["train"][1]} == {"all-gather", "all-reduce",
                                                "reduce-scatter"}


def _kernel_cases():
    rng = np.random.RandomState(0)

    def f32(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    def ints(lo, hi, *shape):
        return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int32))

    b, s, nq, nkv, hd = 2, 16, 4, 2, 16
    pos = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    flash = ((f32(b, s, nq, hd), f32(b, s, nkv, hd), f32(b, s, nkv, hd), pos,
              pos.clone(), torch.ones((b, s), dtype=torch.bool)),
             {"window": 0})
    decode = ((f32(b, 1, nq, hd), f32(b, s, nkv, hd), f32(b, s, nkv, hd),
               torch.tensor([5, 20], dtype=torch.int32),
               torch.ones((b, s), dtype=torch.bool)), {})
    nh, hp, ds = 2, 32, 32
    ssd = ((f32(b, s, nh, hp), f32(b, s, nh).abs() * 0.1,
            -f32(nh).abs() - 0.5, f32(b, s, ds), f32(b, s, ds),
            torch.ones(nh)), {"chunk": 8})
    merge = ((ints(1, 50, b, 12), ints(0, 100, b, 12), ints(0, 2, b, 12),
              ints(1, 50, b, 4), ints(100, 200, b, 4), ints(0, 2, b, 4)),
             {"out_len": 8})
    return {"flash_attention": (flash_attention, attention_ref, flash),
            "decode_attention": (decode_attention, decode_attention_ref,
                                 decode),
            "ssd_scan": (ssd_scan, ssd_chunked, ssd),
            "history_merge": (history_merge, history_merge_ref, merge)}


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssd_scan", "history_merge"])
def test_kernel_meta_route(name):
    op, plain, (args, kwargs) = _kernel_cases()[name]
    launches = op.launches
    want = _tuple(plain(*args, **kwargs))
    for g, w in zip(_tuple(op(*args, **kwargs)), want):   # the CPU route
        assert torch.equal(g, w)
    meta = [a.to("meta") for a in args]
    outs = _tuple(op(*meta, **kwargs))            # no analysis active
    assert [(o.device.type, o.shape, o.dtype) for o in outs] == \
        [("meta", w.shape, w.dtype) for w in want]
    with FlopCounterMode(display=False) as fc:
        plain(*args, **kwargs)
    _, cost = analyze(lambda *a: op(*a, **kwargs), meta)
    out_bytes = sum(w.numel() * w.element_size() for w in want)
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    assert cost.flops == fc.get_total_flops()
    if name != "history_merge":
        assert cost.flops > 0
    # the outputs, and none of the plain version's intermediates
    assert cost.peak_bytes == out_bytes == cost.output_bytes
    assert cost.bytes_accessed == in_bytes + out_bytes
    assert cost.top_bytes[0][1] == name
    assert op.launches == launches
    # the meta route checks its inputs as the CUDA route does
    bad = list(meta)
    bad[0] = bad[0].to(torch.float64 if name != "history_merge"
                       else torch.int64)
    with pytest.raises(ValueError):
        op(*bad, **kwargs)


def test_abstract_mesh_collectives():
    mesh = MeshShape((2, 4), ("data", "model"))
    x = torch.empty((3, 8), device="meta")

    def step(x):
        return all_gather(all_reduce(x, mesh, "model"), mesh, "data", 1)

    out, cost = analyze(step, (x,))
    assert out.shape == (3, 16) and out.device.type == "meta"
    assert cost.collectives == [("all-reduce", ("model",), 4, 96),
                                ("all-gather", ("data",), 2, 192)]
    assert cost.wire_bytes == 96 * 2 * 3 / 4 + 192 / 2
    # outside an analysis nothing is recorded, and the shapes still hold
    assert all_gather(x, mesh, ("data", "model"), 0).shape == (24, 8)
    with pytest.raises(ValueError, match="meta"):
        all_reduce(torch.zeros(3, 8), mesh, "model")


def test_live_bytes_exact_on_a_toy_step():
    n = 1000

    def toy(x, y):
        a = x * y                 # 4n new bytes
        b = a + y                 # 4n more: a and b live at once
        del a
        s = b.sum()               # 4 bytes, a freed
        x.add_(y)                 # in place on an argument: nothing new
        return s, x

    x, y = torch.ones(n), torch.full((n,), 2.0)
    (s, x2), cost = analyze(toy, (x, y))
    assert float(s) == 4 * n and x2 is x
    assert cost.peak_bytes == 8 * n
    assert cost.output_bytes == 4 + 4 * n      # s, and x updated in place
    # mul, add and add_ read two and write one; sum reads n and writes 1
    assert cost.bytes_accessed == 3 * 12 * n + 4 * n + 4
    assert cost.flops == 0


@pytest.mark.parametrize("spec", [("model", None), (None, "model")])
def test_local_shard_keeps_only_its_block(spec):
    """A rank's block of a tensor cut over rows or columns holds a
    storage of the block's own bytes: a row block kept as a view held
    the whole table (the untied heads of deepseek-67b and
    command-r-plus-104b, 1.26 and 4.72 GB more a card at 1x4 than the
    dry run's estimate)."""
    from repro_torch.sharding.local import local_shard
    from repro_torch.sharding.rules import P
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    got = local_shard(x, P(*spec), MeshShape((1, 4), ("data", "model")))
    want = x[:2] if spec[0] else x[:, :1]
    assert torch.equal(got, want) and got.is_contiguous()
    assert got.untyped_storage().nbytes() == want.numel() * 4
    assert local_shard(x, P(None, None), ONE) is x


def test_normal_init_holds_one_f32_copy():
    """The init draws a leaf in f32 and scales it in place: the f32 draw
    and the cast are all it holds at once (a second f32 copy ran
    command-r-plus-104b's 12.6 GB head out of a card's memory at 1x4),
    and the values are those of the draw scaled out of place."""
    from repro_torch.models.common import normal_init
    shape, std = (300, 40), 0.02
    _, cost = analyze(lambda: normal_init(torch.Generator(), shape, std,
                                          torch.bfloat16, "meta"), ())
    n = 300 * 40
    assert cost.peak_bytes == 4 * n + 2 * n
    got = normal_init(torch.Generator().manual_seed(3), shape, std,
                      torch.bfloat16, "cpu")
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, (x * std).to(torch.bfloat16))


BENCH_ROOFLINE_KEYS = ("arch", "shape", "mesh", "chips", "status", "fits",
                       "trace_s")
MEMORY_KEYS = ("argument", "output", "temp", "alias", "peak")
ROOFLINE_KEYS = ("compute_s", "memory_s", "collective_s", "dominant",
                 "model_flops", "useful_flops_ratio", "collective_counts",
                 "collective_bytes_by_kind",
                 "collective_wire_bytes_per_device", "chips")


def _check_result(r, tmp_path, arch, shape, mesh, chips):
    assert [r[k] for k in ("arch", "shape", "mesh", "chips", "status")] \
        == [arch, shape, mesh, chips, "ok"]
    for k in BENCH_ROOFLINE_KEYS:
        assert k in r, k
    m = r["memory"]
    for k in MEMORY_KEYS:
        assert m[f"{k}_bytes_per_device"] >= 0, k
    assert m["peak_bytes_per_device"] >= m["argument_bytes_per_device"] > 0
    assert r["fits"] == (m["peak_bytes_per_device"] <= 80e9)
    assert set(r["roofline"]) == set(ROOFLINE_KEYS)
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    on_disk = json.loads((tmp_path / f"{arch}_{shape}_{mesh}.json")
                         .read_text())
    assert on_disk["memory"] == m and on_disk["fits"] == r["fits"]


def test_run_one_1x4_and_two_pods(tmp_path):
    r = dryrun.run_one("mixtral-8x22b", "prefill_32k", False, str(tmp_path),
                       mesh=(1, 4))
    _check_result(r, tmp_path, "mixtral-8x22b", "prefill_32k", "mesh_1x4",
                  4)
    # the whole global batch of 32 x 32768 on four cards does not fit
    assert not r["fits"]
    assert r["memory"]["argument_bytes_per_device"] > 70e9
    r = dryrun.run_one("llama3.2-1b", "long_500k", True, str(tmp_path))
    _check_result(r, tmp_path, "llama3.2-1b", "long_500k",
                  "multipod_2x16x16", 512)


def test_cli_deepseek_decode_on_the_pod(background):
    """``python -m repro_torch.launch.dryrun --arch deepseek-67b --shape
    decode_32k``, in one subprocess."""
    cli, out_dir = background["cli"]
    stdout, stderr = cli.communicate(timeout=180)
    assert cli.returncode == 0, stderr
    line = stdout.strip().splitlines()[-1]
    assert line.startswith("OK  deepseek-67b") and "pod_16x16" in line
    r = json.loads((out_dir / "deepseek-67b_decode_32k_pod_16x16.json")
                   .read_text())
    _check_result(r, out_dir, "deepseek-67b", "decode_32k", "pod_16x16", 256)
    # the batch of 128 splits over the 16 data ranks; the weights are
    # gathered over data, the kv-8 cache's head_dim over model
    assert r["roofline"]["collective_counts"]["all-gather"] > 0
    assert r["fits"]


def test_slot_pool_check(background):
    """``tools/torch_slot_pool_check.py``: a pooled Gateway on an 8x1
    gloo mesh, whose pool gathers and scatters record no collective."""
    proc = background["slot_pool"]
    stdout, stderr = proc.communicate(timeout=240)
    assert proc.returncode == 0, stderr
    assert stdout.strip().splitlines()[-1] == "SLOT-POOL OK collectives=0"
