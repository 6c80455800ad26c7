"""The port's ``ServingEngine`` against the JAX package's on
``reduced(mamba2-780m)`` (2 Mamba2 layers, d 256, 16 SSD heads of 32).

Both engines run ``max_batch=4``, ``prefill_len=32``, ``inject_len=8`` and
``cache_capacity=64``, with the same weights (JAX ``init_params``,
converted) and the same inputs, fp32 with TF32 off: a user with no
history and a user with no fresh events included. Logits within 1e-5
absolute and relative (XLA and torch order their f32 sums differently);
the SSM caches (conv tails, f32 state) within the same; greedy slates
equal, ``row_lens`` tails included. The engine runs unchanged: nothing in
it assumes K/V caches.
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
from repro.models.model import init_params as jax_init_params
from repro.serving.engine import ServingConfig as JaxServingConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.serving import ServingConfig, ServingEngine
from repro_torch.weights import params_from_numpy
from torch_port import port_cfg

TOL = dict(atol=1e-5, rtol=1e-5)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(max_batch=4, prefill_len=32, inject_len=8, cache_capacity=64)
HISTS = [[5, 7, 9, 11, 13, 2, 4, 6], list(range(100, 140)), [300], []]
FRESH = [[21, 22, 23], [30], [], [40, 41, 42, 43, 44, 45, 46, 47, 48]]
FRESH2 = [[50], [51, 52], [53, 54, 55], []]


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_reduced(jax_get_config("mamba2-780m"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jeng = JaxServingEngine(jcfg, jparams, JaxServingConfig(**SHAPE))
    cfg = port_cfg(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    eng = ServingEngine(cfg, params, ServingConfig(**SHAPE), device="cpu")
    return jeng, eng


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **TOL)


def _close_caches(got, want):
    assert set(got) == set(want) == {"pos0"}
    assert set(got["pos0"]) == {"conv_x", "conv_B", "conv_C", "state"}
    for name, w in want["pos0"].items():
        _close(got["pos0"][name], w)


def _states(engines, rounds=(FRESH,), fallback=True):
    """prefill -> inject (one or more rounds) on both engines."""
    out = []
    for e in engines:
        toks, valid = e.pad_tokens(HISTS, 32)
        pre = e.prefill(toks, valid)
        st = pre
        for fresh in rounds:
            stoks, svalid = e.pad_tokens(fresh, 8, align="left")
            fb = st["logits"][:, -1] if fallback else None
            st = e.inject(st, stoks, svalid, fallback_logits=fb)
        out.append((pre, st))
    return out


def test_prefill_and_inject_match_jax(engines):
    (jpre, jst), (pre, st) = _states(engines)
    _close(pre["logits"][:, -1], jpre["logits"][:, -1])
    _close_caches(pre["caches"], jpre["caches"])
    for key in ("next_pos", "n_valid", "valid"):
        np.testing.assert_array_equal(_np(st[key]), np.asarray(jst[key]))
    for key in ("last_valid_logits", "first_logits"):
        _close(st[key], jst[key])
    _close_caches(st["caches"], jst["caches"])
    assert int(st["n_valid"][2]) == 0
    assert torch.equal(st["first_logits"][2], pre["logits"][2, -1])


def test_inject_without_fallback_matches_jax(engines):
    (_, jst), (_, st) = _states(engines, fallback=False)
    assert "first_logits" not in st and "first_logits" not in jst
    _close(st["last_valid_logits"], jst["last_valid_logits"])


def test_finalize_and_decode_match_jax(engines):
    """``finalize`` copies the SSM caches as they are; three decode steps;
    the caller's decode cache is left as it was."""
    jeng, eng = engines
    (_, jst), (_, st) = _states(engines)
    jdec, dec = jeng.finalize(jst), eng.finalize(st)
    _close_caches(dec["caches"], jdec["caches"])
    before = {n: t.clone() for n, t in dec["caches"]["pos0"].items()}
    dec0 = dec
    tok = np.array([[50], [60], [70], [80]], np.int32)
    for _ in range(3):
        jlog, jdec = jeng.decode(jdec, tok)
        log, dec = eng.decode(dec, tok)
        _close(log, jlog)
        _close_caches(dec["caches"], jdec["caches"])
        tok = np.asarray(jeng.sample(jlog))[:, None]
        np.testing.assert_array_equal(_np(eng.sample(log))[:, None], tok)
    for n, t in dec0["caches"]["pos0"].items():
        assert torch.equal(t, before[n])


@pytest.mark.parametrize("rounds,row_lens", [
    ((FRESH,), None),
    ((FRESH,), [5, 1, 3, 0]),
    ((FRESH, FRESH2), None),     # two injection rounds
])
def test_decode_slate_matches_jax(engines, rounds, row_lens):
    jeng, eng = engines
    (_, jst), (_, st) = _states(engines, rounds=rounds)
    lens = None if row_lens is None else np.array(row_lens, np.int32)
    want = jeng.decode_slate(jst, jst["first_logits"], 5, row_lens=lens)
    got = eng.decode_slate(st, st["first_logits"], 5, row_lens=lens)
    assert got.dtype == np.int32 and got.shape == (4, 5)
    np.testing.assert_array_equal(got, want)
    # the in-place decode steps left the injected state as it was
    _close_caches(st["caches"], jst["caches"])
    assert np.array_equal(eng.decode_slate(st, st["first_logits"], 5,
                                           row_lens=lens), got)
    for row in got:
        items = row[row >= 0]
        assert len(set(items.tolist())) == len(items)


def test_serve_launcher_runs_mamba2_on_cpu_without_jax():
    """The launcher's three phases on ``reduced(mamba2-780m)`` (SSM
    layers, no K/V caches), on the CPU with ``jax`` made unimportable."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "sys.argv = ['serve', '--arch', 'mamba2-780m', '--reduced',\n"
        "            '--device', 'cpu', '--batch', '2', '--history', '16',\n"
        "            '--fresh', '4', '--decode-steps', '2']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for phase in ("SSD heads of 32", "prefill(batch hist)",
                  "inject(fresh events)", "finalize(ring cache)",
                  "decode: 2 steps"):
        assert phase in out.stdout, out.stdout
