"""``python -m repro_torch.launch.train``, the port's training launcher.

On the CPU (``--device cpu``, with ``jax`` made unimportable in the
launcher's process) a reduced ``llama3.2-1b`` trains 3 steps and writes a
checkpoint through the port's codec. The JAX package's
``load_checkpoint`` must read it back as the JAX launcher's tree:
``{"params": ...}`` with the JAX ``init_params``' paths, shapes and
dtypes (f32 at ``--reduced``), the step count and ``{"arch": name}``.
Without ``--device cpu`` and with no card, the launcher raises instead
of falling back to the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models.model import param_shapes as jax_param_shapes
from repro.training.checkpoint import load_checkpoint as jax_load_checkpoint

ROOT = Path(__file__).resolve().parents[1]


def _run_launcher(args):
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['msgpack'] = None\n"
        f"sys.argv = ['train'] + {args!r}\n"
        "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=180)


def test_launcher_checkpoint_reads_in_jax(tmp_path):
    ckpt = tmp_path / "out.msgpack"
    out = _run_launcher(["--arch", "llama3.2-1b", "--reduced", "--steps",
                         "3", "--batch", "2", "--seq", "32", "--device",
                         "cpu", "--ckpt", str(ckpt)])
    assert out.returncode == 0, out.stderr
    assert "arch=llama3.2-1b-reduced" in out.stdout
    assert "step     0 loss=" in out.stdout
    assert f"saved {ckpt}" in out.stdout
    tree, step, meta = jax_load_checkpoint(str(ckpt))
    assert step == 3
    assert meta == {"arch": "llama3.2-1b-reduced"}
    assert set(tree) == {"params"}
    want = jax_param_shapes(jax_reduced(jax_get_config("llama3.2-1b")),
                            jnp.float32)
    got_flat = {jax.tree_util.keystr(p): x for p, x in
                jax.tree_util.tree_flatten_with_path(tree["params"])[0]}
    want_flat = {jax.tree_util.keystr(p): x for p, x in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(got_flat) == set(want_flat)
    for path, w in want_flat.items():
        x = np.asarray(got_flat[path])
        assert x.shape == tuple(w.shape) and x.dtype == np.float32, path
        assert np.isfinite(x).all(), path


def test_launcher_refuses_cpu_fallback(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "1",
                    "--batch", "2", "--seq", "8"])
