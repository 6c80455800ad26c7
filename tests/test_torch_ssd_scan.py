"""The port's SSD scan plain versions against the JAX package's, and the
CUDA kernel's schedule and arithmetic emulated on the CPU.

The same numpy inputs go through the port's ``ssd_chunked`` and
``ssd_ref_sequential`` and the JAX ``ssd_chunked``, ``ssd_ref_sequential``
and ``ssd_scan(..., interpret=True)`` (the Pallas kernel run as the JAX
package's own tests run it here), at ``tests/test_kernels.py``'s shapes and
tolerances: 2e-5 in fp32 and 3e-2 in bf16 for y (different summation
orders; bf16 rounds y once), 1e-3 for the final state against the
sequential recurrence. Each package's chunked path is held against a
float64 recurrence of the same inputs, within its own f32 error plus 1e-5
(the two packages' f32 sums are ordered by their thread counts).

``_kernel_order`` repeats what ``csrc/ssd_scan.cu`` sums and in which
tiles: a CTA per (batch row, block of two heads), a shuffle scan of dt * A
per 32 rows, 16-row tiles in bands of 64, C_i B_j^T once per tile pair for
the block, G' = (C_i B_j^T) exp(cum_i - cum_j) dt_j selected only where
j <= i, and in bf16 every f32 operand split into hi and lo bf16 parts with
torch's bf16 rounding. It is held against the sequential recurrence, with
decays strong enough that exp(cum_i - cum_j) overflows above the diagonal,
with padded (dt = 0) rows, with nh that the head block does not divide,
and on fully live rows.
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

TILE, BAND, HEAD_BLOCK = 16, 64, 2  # kR, kBand, kHB of csrc/ssd_scan.cu

# The first multithreaded torch.exp of a process can compute one thread's
# share of the tensor on a less exact path (errors ~1e-4, in ~1 of 5 fresh
# processes on torch 2.13+cpu), which put the port's ssd_chunked up to 7e-5
# off the float64 recurrence. Make that first call here, at import, before
# any test: every test process imports this module while collecting.
torch.exp(torch.zeros(1 << 17))


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


def _truth(arrs):
    """The token-by-token recurrence of numpy inputs in float64: (y, h)."""
    x, dt, A, B, C, D = (np.asarray(a, np.float64) for a in arrs)
    b, s, nh, hp = x.shape
    h = np.zeros((b, nh, hp, B.shape[-1]))
    ys = []
    for t in range(s):
        h = np.exp(dt[:, t] * A)[:, :, None, None] * h + np.einsum(
            "bh,bhp,bs->bhps", dt[:, t], x[:, t], B[:, t])
        ys.append(np.einsum("bs,bhps->bhp", C[:, t], h)
                  + D[None, :, None] * x[:, t])
    return np.stack(ys, 1), h


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
    # each package's chunked scan against the float64 recurrence, within its
    # own f32 error (its sequential version's, against the same truth) plus
    # the margin: f32 sums whose order follows the thread count differ
    # between the two packages by more than either is off the truth
    y64, h64 = _truth(arrs)
    margin = tol if dtype == "bfloat16" else dict(atol=1e-5, rtol=1e-5)
    for name, y, h, y_seq, h_seq in (("port", yc, hc, ys, hs),
                                     ("jax", yjc, hjc, yjs, hjs)):
        own_y = np.abs(_f32(y_seq) - y64).max()
        own_h = np.abs(_f32(h_seq) - h64).max()
        np.testing.assert_allclose(_f32(y), y64, rtol=margin["rtol"],
                                   atol=margin["atol"] + own_y, err_msg=name)
        np.testing.assert_allclose(_f32(h), h64, rtol=1e-5,
                                   atol=1e-5 + own_h, err_msg=name)
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


def _scan(v):
    """csrc/ssd_scan.cu's inclusive scan over the chunk axis (dim 0): a
    shuffle-up scan within each group of 32 rows, plus the running total
    of the groups before it. Rows up to the next multiple of 32 are kept
    (their dt is 0, so they repeat the chunk's last sum)."""
    q = v.shape[0]
    out = torch.zeros((-(-q // 32) * 32,) + tuple(v.shape[1:]))
    out[:q] = v
    carry = torch.zeros(v.shape[1:])
    for w0 in range(0, out.shape[0], 32):
        seg = out[w0:w0 + 32]
        for off in (1, 2, 4, 8, 16):
            seg = torch.cat([seg[:off], seg[off:] + seg[:-off]], 0)
        out[w0:w0 + 32] = seg + carry
        carry = out[w0 + 31].clone()
    return out


def _split(v):
    """An f32 operand as the kernel gives it to the bf16 tensor cores:
    hi = bf16(v) and lo = bf16(v - hi), each multiplied in turn."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _exact(v):
    """fp32: the kernel's CUDA-core products take the operand as it is."""
    return v, torch.zeros_like(v)


def _kernel_order(x, dt, A, B, C, D, chunk, h0=None, head_block=HEAD_BLOCK):
    """csrc/ssd_scan.cu's schedule and arithmetic, one (batch row, block of
    ``head_block`` heads) at a time: 16-row tiles in bands of 64, row tiles
    whose dt are all 0 for the block skipped, C_i B_j^T once per tile pair
    for the block, G' = (C_i B_j^T) exp(cum_i - cum_j) dt_j selected only
    where j <= i, the inter term skipped while the state is zero, the
    state update over the live tiles; in bf16 each f32 operand (G', the
    state, x dt exp(cum_last - cum)) split into hi and lo bf16 parts. Rows
    past the chunk's end in its last tile are zeros, as staged."""
    b, s, nh, hp = x.shape
    ds = B.shape[-1]
    split = _split if x.dtype == torch.bfloat16 else _exact
    xf, Bf, Cf = x.float(), B.float(), C.float()
    y = torch.empty((b, s, nh, hp))
    hout = torch.empty((b, nh, hp, ds))
    rows16 = -(-chunk // TILE) * TILE
    for bi, hb, c0 in ((bi, hb, c0) for bi in range(b)
                       for hb in range(0, nh, head_block)
                       for c0 in range(0, s, chunk)):
        hs = slice(hb, min(hb + head_block, nh))
        if c0 == 0:   # the block's state; None while it is zero
            st = None if h0 is None else h0[bi, hs].clone()

        def rows(t):
            out = torch.zeros((rows16,) + tuple(t.shape[1:]))
            out[:chunk] = t[c0:c0 + chunk]
            return out
        xc, dtc = rows(xf[bi, :, hs]), rows(dt[bi, :, hs])
        Bc, Cc = rows(Bf[bi]), rows(Cf[bi])
        cum = _scan(dtc * A[hs])[:rows16]                  # (rows16, hv)
        cl = cum[chunk - 1]
        w = dtc * torch.exp(cl - cum)
        live = [bool((dtc[j0:j0 + TILE] != 0).any())
                for j0 in range(0, rows16, TILE)]
        for b0 in range(0, rows16, BAND):
            band_end = min(b0 + BAND, rows16)
            for i0 in range(b0, band_end, TILE):
                gi = torch.arange(i0, i0 + TILE)
                ci = Cc[gi]
                acc = torch.zeros((TILE, st.shape[0] if st is not None
                                   else dtc.shape[1], hp))
                if st is not None:                          # inter term
                    hi, lo = split(st)
                    acc = (torch.einsum("is,hps->ihp", ci, hi)
                           + torch.einsum("is,hps->ihp", ci, lo)) \
                        * torch.exp(cum[gi])[..., None]
                for j0 in range(0, band_end, TILE):         # intra term
                    if not live[j0 // TILE] or j0 > i0:
                        continue
                    gj = torch.arange(j0, j0 + TILE)
                    S = ci @ Bc[gj].T                       # once a block
                    below = (gj[None, :] <= gi[:, None])[..., None]
                    seg = cum[gi][:, None] - cum[gj][None, :]
                    # exp only where j <= i: select, never multiply by a mask
                    G = torch.where(below, S[..., None] * torch.exp(
                        torch.where(below, seg, 0.0)) * dtc[gj][None], 0.0)
                    hi, lo = split(G)                       # (i, j, hv)
                    acc = acc + torch.einsum("ijh,jhp->ihp", hi, xc[gj]) \
                        + torch.einsum("ijh,jhp->ihp", lo, xc[gj])
                out = acc + D[hs][None, :, None] * xc[gi]
                n = min(TILE, chunk - i0)
                y[bi, c0 + i0:c0 + i0 + n, hs] = out[:n]
        if any(live) or st is not None:                     # state update
            new = torch.zeros((dtc.shape[1], hp, ds)) if st is None \
                else torch.exp(cl)[:, None, None] * st
            for j0 in range(0, rows16, TILE):
                if live[j0 // TILE]:
                    gj = torch.arange(j0, j0 + TILE)
                    hi, lo = split(xc[gj] * w[gj][..., None])
                    new = new + torch.einsum("jhp,js->hps", hi, Bc[gj]) \
                        + torch.einsum("jhp,js->hps", lo, Bc[gj])
            st = new
        if c0 + chunk == s:
            hout[bi, hs] = 0.0 if st is None else st
    return y.to(x.dtype), hout


@pytest.mark.parametrize("s,chunk,decay,dtype", [
    (64, 16, 1.0, "float32"),    # a chunk of one tile
    (96, 48, 1.0, "float32"),    # three tiles: a band with an idle warp
    (128, 64, 40.0, "float32"),  # decay that overflows above the diagonal
    (24, 24, 1.0, "float32"),    # reduced mamba2's prefill chunk: 1.5 tiles
    (64, 64, 40.0, "bfloat16"),
])
def test_kernel_order_matches_sequential(s, chunk, decay, dtype):
    _check_kernel_order(s, 4, chunk, dtype, decay, padded=True)


@pytest.mark.parametrize("s,nh,chunk,dtype,padded", [
    (32, 4, 8, "float32", True),       # a chunk shorter than a tile
    (48, 3, 24, "bfloat16", True),     # nh 3: a block of 2 heads and one of 1
    (96, 5, 96, "float32", True),      # nh 5; a band and a half
    (256, 4, 128, "bfloat16", False),  # fully live: two bands, two chunks
    (128, 3, 128, "float32", False),   # fully live, nh 3
])
def test_kernel_order_head_blocks(s, nh, chunk, dtype, padded):
    _check_kernel_order(s, nh, chunk, dtype, 1.0, padded)


def _check_kernel_order(s, nh, chunk, dtype, decay, padded):
    """The emulation against the sequential recurrence and the chunked
    version, from a random state; with ``padded``, row 1 is left-padded
    and row 2 all padding, which must keep its state bit for bit."""
    arrs = list(_inputs(6, 3, s, nh, 32, 64, dtype, decay))
    if padded:
        arrs[1][1, :s // 3] = 0.0       # left-padded row
        arrs[1][2] = 0.0                # all padding
    t = _torch(arrs, dtype)
    h0 = torch.from_numpy(np.random.RandomState(7).normal(
        size=(3, nh, 32, 64)).astype(np.float32))
    y, h = _kernel_order(*t, chunk=chunk, h0=h0)
    ys, hs = ssd_ref_sequential(*t, h0)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(_f32(y), _f32(ys), **_tol(dtype))
    np.testing.assert_allclose(h.numpy(), hs.numpy(), atol=1e-3, rtol=1e-3)
    if padded:
        assert torch.equal(h[2], h0[2])
    yc, hc = ssd_chunked(*t, chunk=chunk, init_state=h0)
    np.testing.assert_allclose(_f32(y), _f32(yc), **_tol(dtype))
