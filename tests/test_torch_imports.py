"""Import guards for the PyTorch port (``src/repro_torch``).

The port imports ``torch`` and numpy, never ``jax`` and nothing of the JAX
package ``repro``; its entry points run on the CUDA device unless the
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
    r"^\s*(?:import|from)\s+(?:jax|msgpack|repro)(?:\.|\s|$)", re.M)


def test_import_without_jax():
    """Every module of the port imports with ``jax`` made unimportable,
    and no module of ``repro`` comes along."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
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
