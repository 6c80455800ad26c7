"""``tools/torch_sharded_equiv_check.py`` in a subprocess: the JAX
equivalence tool's trace on the port's one-device Gateway and on gloo
meshes of 4x1, 2x2 (host LRU and pool) and 1x4 (head_dim on the model
axis, as the tiny model's two kv heads do not divide 4)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("extra", [["--mesh", "4,1"], ["--mesh", "2,2"],
                                   ["--mesh", "1,4"],
                                   ["--mesh", "2,2", "--pool", "16"]],
                         ids=["4x1", "2x2", "1x4", "2x2-pool"])
def test_equivalence_tool(extra):
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_sharded_equiv_check.py"),
         "--device", "cpu"] + extra,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "TORCH-SHARDED-EQUIV OK" in out.stdout, out.stdout
    assert out.stdout.count("slates equal") == 5, out.stdout
