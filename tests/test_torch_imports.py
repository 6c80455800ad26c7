"""Import guards for the PyTorch port (``src/repro_torch``).

The port imports ``torch`` and numpy, never ``jax``, ``msgpack``,
``ml_dtypes`` or anything of the JAX package ``repro`` (its checkpoint and
patch formats carry their own msgpack codec and bf16 views); its entry points run on the CUDA device unless the
caller passes ``device="cpu"``, and never fall back to the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|msgpack|ml_dtypes|repro)(?:\.|\s|$)",
    re.M)


def test_import_without_jax():
    """Every module of the port, ``training/`` and the dry run's
    ``launch/`` modules included, imports with
    ``jax``, ``msgpack`` and ``ml_dtypes`` made unimportable, and no
    module of ``repro`` comes along."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                                               'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('checkpoint', 'losses', 'online', 'optimizer',\n"
        "             'train_loop', '_msgpack'):\n"
        "    assert 'repro_torch.training.' + name in names, name\n"
        "for name in ('dryrun', 'roofline', 'op_analysis'):\n"
        "    assert 'repro_torch.launch.' + name in names, name\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + [str(p.relative_to(ROOT)) for p in (ROOT / "tools").glob("torch_*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_or_repro(path):
    """A source scan: no ``import``/``from`` of jax, msgpack or repro."""
    src = (ROOT / path).read_text()
    assert not FORBIDDEN.findall(src), path


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no CUDA device, the default device raises instead of running
    on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core import (BatchFeatureStore, FeatureInjector,
                                  FeatureStoreConfig, InjectionConfig,
                                  PipelineConfig, RecommenderPlatform)
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("itfi-ranker")
    store = BatchFeatureStore(FeatureStoreConfig(n_users=2, feature_len=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeatureInjector(InjectionConfig(feature_len=8), store, None)
    inj = FeatureInjector(InjectionConfig(feature_len=8), store, None,
                          device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    pcfg = PipelineConfig(n_items=cfg.vocab_size - 256, serve_batch=2)
    pop = np.full(pcfg.n_items, 1.0 / pcfg.n_items)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RecommenderPlatform(pcfg, cfg, params, inj, pop)
    RecommenderPlatform(pcfg, cfg, params, inj, pop, device="cpu")
    scfg = ServingConfig(max_batch=2, prefill_len=8, inject_len=4,
                         cache_capacity=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params, scfg)
    ServingEngine(cfg, params, scfg, device="cpu")

    from repro_torch.launch.mesh import make_serving_mesh, run_on_mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serving_mesh(1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_on_mesh(1, 1, print)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params, scfg, mesh=object())

    from repro_torch.core.ab import (ABConfig, make_platform, run_experiment,
                                     train_ranker)
    from repro_torch.data.synthetic import World, WorldConfig
    ab = ABConfig(world=WorldConfig(n_users=4, n_items=pcfg.n_items),
                  bootstrap_days=0)
    world = World(ab.world)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_platform(ab, cfg, params, world, [], policy="batch")
    make_platform(ab, cfg, params, world, [], policy="batch", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_ranker([], cfg, ab, "midnight", log=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment(ab, model_cfg=cfg, log=None)

    from repro_torch.serving.loadgen import (_engine_for, build_gateway,
                                             get_scenario, run_scenario)
    spec = get_scenario("churn_heavy", smoke=True)
    for call in (lambda: _engine_for(spec, None),
                 lambda: build_gateway(spec),
                 lambda: run_scenario(spec, warmup=False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert _engine_for(spec, None, "cpu").device.type == "cpu"


def test_serve_launcher_runs_on_cpu_without_jax():
    """``python -m repro_torch.launch.serve`` runs the three-phase token
    path on the CPU with ``jax`` made unimportable."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "sys.argv = ['serve', '--arch', 'itfi-ranker', '--reduced',\n"
        "            '--device', 'cpu', '--batch', '2', '--history', '16',\n"
        "            '--fresh', '4', '--decode-steps', '2']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for phase in ("prefill(batch hist)", "inject(fresh events)",
                  "finalize(ring cache)", "decode: 2 steps"):
        assert phase in out.stdout, out.stdout
