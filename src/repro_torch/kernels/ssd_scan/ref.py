"""Plain PyTorch versions of the Mamba2 SSD scan (state-space duality,
[arXiv:2405.21060]): per head, with a (head_dim, d_state) state,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) ⊗ B_t
    y_t = C_t · h_t + D * x_t

``ssd_chunked`` is the JAX package's ``models/ssm.py::ssd_chunked``: an
intra-chunk quadratic term plus a recurrence over chunk states.
``ssd_ref_sequential`` is its ``kernels/ssd_scan/ref.py``: the token-by-token
recurrence, the ground truth both are held against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _segsum(x):
    """(..., Q) -> (..., Q, Q) lower-triangular cumulative segment sums:
    out[i, j] = sum_{j < t <= i} x[t], -inf above the diagonal (set before
    the exp, so exp gives 0 there and never overflows)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(x, dt, A, B, C, D, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,s,nh,hp); dt (b,s,nh) post-softplus; A (nh,) negative; B,C
    (b,s,ds); D (nh,); init_state (b,nh,hp,ds) or None (zeros). Returns
    (y (b,s,nh,hp) in x.dtype, final state (b,nh,hp,ds) f32)."""
    b, s, nh, hp = x.shape
    ds = B.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk

    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    A, D = A.float(), D.float()

    def r(t):  # (b,s,...) -> (b,nc,chunk,...)
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    xc, dtc, Bc, Cc = r(xf), r(dtf), r(Bf), r(Cf)
    dA = dtc * A[None, None, None, :]                   # (b,nc,Q,nh)
    dA_cum = torch.cumsum(dA, dim=2)                    # within-chunk

    # intra-chunk (quadratic) term
    L = torch.exp(_segsum(dA.movedim(2, 3)))            # (b,nc,nh,Q,Q)
    scores = torch.einsum("bcis,bcjs->bcij", Cc, Bc)    # (b,nc,Q,Q)
    M = scores[:, :, None] * L                          # (b,nc,nh,Q,Q)
    y_intra = torch.einsum("bchij,bcjh,bcjhp->bcihp", M, dtc, xc)

    # chunk states + inter-chunk recurrence
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (b,nc,Q,nh)
    chunk_states = torch.einsum("bcjs,bcjh,bcjhp->bchps", Bc,
                                dtc * decay_to_end, xc)  # (b,nc,nh,hp,ds)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])        # (b,nc,nh)

    h = (torch.zeros((b, nh, hp, ds), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)                                  # state entering c
        h = chunk_decay[:, c, :, None, None] * h + chunk_states[:, c]
    h_in = torch.stack(h_in, dim=1)                     # (b,nc,nh,hp,ds)

    decay_from_start = torch.exp(dA_cum)                # (b,nc,Q,nh)
    y_inter = torch.einsum("bcis,bcih,bchps->bcihp", Cc, decay_from_start,
                           h_in)

    y = y_intra + y_inter + D[None, None, None, :, None] * xc
    return y.reshape(b, s, nh, hp).to(x.dtype), h


def ssd_ref_sequential(x, dt, A, B, C, D, h0=None):
    """Token-by-token recurrence. Same signature and shapes as the kernel."""
    b, s, nh, hp = x.shape
    ds = B.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    A, D = A.float(), D.float()
    h = (torch.zeros((b, nh, hp, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        a = torch.exp(dtf[:, t] * A[None, :])
        h = a[:, :, None, None] * h + torch.einsum(
            "bh,bhp,bs->bhps", dtf[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bs,bhps->bhp", Cf[:, t], h)
                  + D[None, :, None] * xf[:, t])
    return torch.stack(ys, dim=1).to(x.dtype), h
