"""The port's SSD scan plain versions against the JAX package's, and the
CUDA kernel's loop order emulated on the CPU.

The same numpy inputs go through the port's ``ssd_chunked`` and
``ssd_ref_sequential`` and the JAX ``ssd_chunked``, ``ssd_ref_sequential``
and ``ssd_scan(..., interpret=True)`` (the Pallas kernel run as the JAX
package's own tests run it here), at ``tests/test_kernels.py``'s shapes and
tolerances: 2e-5 in fp32 and 3e-2 in bf16 for y (different summation
orders; bf16 rounds y once), 1e-3 for the final state against the
sequential recurrence, 1e-5 between the two packages' chunked paths.

``_kernel_order`` repeats what ``csrc/ssd_scan.cu`` sums and in which
tiles: a warp-wise scan of dt * A, row tiles of 32 within a chunk of any
length, G = (C_i B_j^T) exp(cum_i - cum_j) selected only where j <= i,
the state update over the same row tiles. It is held against the
sequential recurrence, with decays strong enough that exp(cum_i - cum_j)
overflows above the diagonal, and with padded (dt = 0) rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref_sequential as jax_sequential
from repro.models.ssm import ssd_chunked as jax_chunked
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref_sequential

TILE = 32  # kTile of csrc/ssd_scan.cu


def _tol(dtype):
    return dict(atol=3e-2, rtol=3e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, s, nh, hp, ds, dtype="float32", decay=1.0):
    """numpy inputs shaped like test_kernels._ssd_inputs; x, B, C rounded
    to ``dtype``, dt and A f32. ``decay`` scales A."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(b, s, nh, hp)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.normal(size=(b, s, nh)) - 2.0)).astype(
        np.float32)
    A = (-np.exp(rng.normal(size=(nh,)) * 0.3) * decay).astype(np.float32)
    B = rng.normal(size=(b, s, ds)).astype(np.float32) * 0.3
    C = rng.normal(size=(b, s, ds)).astype(np.float32) * 0.3
    D = np.ones((nh,), np.float32)
    if dtype == "bfloat16":
        x, B, C = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                   for a in (x, B, C))
    return x, dt, A, B, C, D


def _jax(arrs, dtype):
    x, dt, A, B, C, D = (jnp.asarray(a) for a in arrs)
    cast = (lambda a: a.astype(jnp.bfloat16)) if dtype == "bfloat16" \
        else (lambda a: a)
    return cast(x), dt, A, cast(B), cast(C), D


def _torch(arrs, dtype):
    x, dt, A, B, C, D = (torch.from_numpy(np.array(a)) for a in arrs)
    td = getattr(torch, dtype)
    return x.to(td), dt, A, B.to(td), C.to(td), D


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("s,nh,hp,ds,chunk,dtype", [
    (128, 8, 32, 64, 32, "float32"),
    (128, 4, 64, 128, 64, "float32"),
    (64, 2, 32, 32, 16, "bfloat16"),
])
def test_plain_versions_match_jax(s, nh, hp, ds, chunk, dtype):
    """The port's chunked and sequential versions against the JAX ones and
    against the Pallas kernel in interpret mode."""
    arrs = _inputs(2, 2, s, nh, hp, ds, dtype)
    j, t = _jax(arrs, dtype), _torch(arrs, dtype)
    yk, hk = jax_ssd_scan(*j, chunk=chunk, interpret=True)
    yjc, hjc = jax_chunked(*j, chunk=chunk)
    yjs, hjs = jax_sequential(*j)
    yc, hc = ssd_chunked(*t, chunk=chunk)
    ys, hs = ssd_ref_sequential(*t)
    assert yc.dtype == ys.dtype == t[0].dtype and hc.dtype == torch.float32
    tol = _tol(dtype)
    np.testing.assert_allclose(_f32(yc), _f32(yjc),
                               **(tol if dtype == "bfloat16" else
                                  dict(atol=1e-5, rtol=1e-5)))
    np.testing.assert_allclose(hc.numpy(), np.asarray(hjc), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_f32(ys), _f32(yjs), **tol)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hjs), atol=1e-5,
                               rtol=1e-5)
    for y, h in ((yc, hc), (ys, hs)):
        np.testing.assert_allclose(_f32(y), _f32(yk), **tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(hk), atol=1e-3,
                                   rtol=1e-3)


def test_plain_versions_with_initial_state_and_padding_match_jax():
    """``init_state``, a left-padded row and a row that is all padding
    (dt = 0): the padded row keeps its incoming state bit for bit."""
    arrs = list(_inputs(3, 3, 64, 4, 32, 64))
    arrs[1][1, :20] = 0.0
    arrs[1][2] = 0.0
    h0 = np.random.RandomState(4).normal(size=(3, 4, 32, 64)).astype(
        np.float32)
    j, t = _jax(arrs, "float32"), _torch(arrs, "float32")
    yk, hk = jax_ssd_scan(*j, chunk=32, init_state=jnp.asarray(h0),
                          interpret=True)
    yjs, hjs = jax_sequential(*j, jnp.asarray(h0))
    yjc, hjc = jax_chunked(*j, chunk=32, init_state=jnp.asarray(h0))
    yc, hc = ssd_chunked(*t, chunk=32, init_state=torch.from_numpy(h0))
    ys, hs = ssd_ref_sequential(*t, torch.from_numpy(h0))
    np.testing.assert_allclose(yc.numpy(), np.asarray(yjc), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(hc.numpy(), np.asarray(hjc), atol=1e-5,
                               rtol=1e-5)
    for y in (yc, ys):
        np.testing.assert_allclose(y.numpy(), np.asarray(yk), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(y.numpy(), np.asarray(yjs), atol=2e-5,
                                   rtol=2e-5)
    for h in (hc, hs):
        np.testing.assert_allclose(h.numpy(), np.asarray(hjs), atol=1e-3,
                                   rtol=1e-3)
        np.testing.assert_array_equal(h[2].numpy(), h0[2])


def test_ssd_scan_on_cpu_is_the_chunked_version():
    """The wrapper's contract on a CPU tensor: ``chunk`` is cut to
    ``min(chunk, s)`` and must divide s; the plain chunked version runs."""
    t = _torch(_inputs(5, 2, 48, 2, 32, 32), "float32")
    y, h = ssd_scan(*t)                       # chunk 256 -> 48
    yc, hc = ssd_chunked(*t, chunk=48)
    assert torch.equal(y, yc) and torch.equal(h, hc)
    y, h = ssd_scan(*t, chunk=16)
    yc, hc = ssd_chunked(*t, chunk=16)
    assert torch.equal(y, yc) and torch.equal(h, hc)
    with pytest.raises(ValueError, match="divisible"):
        ssd_scan(*t, chunk=32)


def _warp_scan(v):
    """csrc/ssd_scan.cu's inclusive scan over the chunk axis (dim 1): a
    shuffle-up scan within each warp of 32, then the totals of the earlier
    warps added one by one."""
    q = v.shape[1]
    out = torch.zeros((v.shape[0], -(-q // 32) * 32) + tuple(v.shape[2:]))
    out[:, :q] = v
    for w0 in range(0, out.shape[1], 32):
        seg = out[:, w0:w0 + 32]
        for off in (1, 2, 4, 8, 16):
            seg = torch.cat([seg[:, :off], seg[:, off:] + seg[:, :-off]], 1)
        out[:, w0:w0 + 32] = seg
    totals = out[:, 31::32].clone()
    for w in range(1, out.shape[1] // 32):
        for prev in range(w):
            out[:, w * 32:(w + 1) * 32] += totals[:, prev:prev + 1]
    return out[:, :q]


def _kernel_order(x, dt, A, B, C, D, chunk, h0=None):
    """The kernel's tiles and order of sums, for all (row, head) at once.
    Rows past the chunk's end in its last tile are zeros, as staged."""
    b, s, nh, hp = x.shape
    xf, Bf, Cf = x.float(), B.float(), C.float()
    st = (torch.zeros((b, nh, hp, B.shape[-1])) if h0 is None
          else h0.clone())
    y = torch.empty((b, s, nh, hp))
    for c0 in range(0, s, chunk):
        rows = slice(c0, c0 + chunk)
        xc, dtc, Bc, Cc = xf[:, rows], dt[:, rows], Bf[:, rows], Cf[:, rows]
        cum = _warp_scan(dtc * A)                        # (b, Q, nh)
        for i0 in range(0, chunk, TILE):
            gi = torch.arange(i0, min(i0 + TILE, chunk))
            acc = torch.einsum("bis,bhps->bihp", Cc[:, gi], st) \
                * torch.exp(cum[:, gi])[..., None]
            for j0 in range(0, i0 + 1, TILE):
                gj = torch.arange(j0, min(j0 + TILE, chunk))
                dot = torch.einsum("bis,bjs->bij", Cc[:, gi], Bc[:, gj])
                seg = cum[:, gi, None, :] - cum[:, None, gj, :]
                below = (gj[None, :] <= gi[:, None])[None, :, :, None]
                # exp only where j <= i: select, never multiply by a mask
                G = torch.where(below, dot[..., None] * torch.exp(
                    torch.where(below, seg, 0.0)), 0.0)  # (b, i, j, nh)
                xdt = xc[:, gj] * dtc[:, gj, :, None]
                acc = acc + torch.einsum("bijh,bjhp->bihp", G, xdt)
            y[:, c0 + gi] = acc + D[:, None] * xc[:, gi]
        hs = torch.exp(cum[:, -1])[:, :, None, None] * st
        for j0 in range(0, chunk, TILE):
            gj = torch.arange(j0, min(j0 + TILE, chunk))
            w = dtc[:, gj] * torch.exp(cum[:, -1:] - cum[:, gj])
            hs = hs + torch.einsum("bjhp,bjs->bhps", xc[:, gj] * w[..., None],
                                   Bc[:, gj])
        st = hs
    return y.to(x.dtype), st


@pytest.mark.parametrize("s,chunk,decay,dtype", [
    (64, 16, 1.0, "float32"),    # chunks shorter than a tile
    (96, 48, 1.0, "float32"),    # a chunk of 1.5 tiles
    (128, 64, 40.0, "float32"),  # decay that overflows above the diagonal
    (24, 24, 1.0, "float32"),    # reduced mamba2's prefill chunk
    (64, 64, 40.0, "bfloat16"),
])
def test_kernel_order_matches_sequential(s, chunk, decay, dtype):
    arrs = list(_inputs(6, 3, s, 4, 32, 64, dtype, decay))
    arrs[1][1, :s // 3] = 0.0       # left-padded row
    arrs[1][2] = 0.0                # all padding
    t = _torch(arrs, dtype)
    h0 = torch.from_numpy(np.random.RandomState(7).normal(
        size=(3, 4, 32, 64)).astype(np.float32))
    y, h = _kernel_order(*t, chunk=chunk, h0=h0)
    ys, hs = ssd_ref_sequential(*t, h0)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(_f32(y), _f32(ys), **_tol(dtype))
    np.testing.assert_allclose(h.numpy(), hs.numpy(), atol=1e-3, rtol=1e-3)
    assert torch.equal(h[2], h0[2])
    yc, hc = ssd_chunked(*t, chunk=chunk, init_state=h0)
    np.testing.assert_allclose(_f32(y), _f32(yc), **_tol(dtype))
