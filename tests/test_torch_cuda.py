"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. Run them on the
machine with the card (no JAX needed there):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

``history_merge`` must be bit-equal to its plain version.
``flash_attention`` and ``decode_attention`` must be within
``tests/test_kernels.py``'s tolerances: 2e-5 in fp32 (different summation
order), 3e-2 in bf16 (the plain versions round the probabilities to bf16
before the PV product, the kernels keep them f32). ``ssd_scan``'s y must be
within the same tolerances of ``ssd_chunked`` (another summation order;
bf16 rounds y once), its f32 final state within 1e-4, and a row that is
all padding (dt = 0) must keep its incoming state bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.history_merge.ops import history_merge
from repro_torch.kernels.history_merge.ref import history_merge_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,lb,lr,k,n_items,t_max", [
    (256, 256, 64, 256, 5000, 10**6),   # the serving design point
    (64, 256, 64, 256, 8, 4),           # duplicate and tie storms
    (33, 40, 0, 16, 30, 100),           # empty realtime side
    (33, 0, 40, 16, 30, 100),           # empty batch side
    (5, 0, 0, 4, 3, 3),                 # both empty
    (7, 2000, 1000, 512, 200, 10**4),   # the largest N the kernel takes
])
def test_history_merge_kernel_bit_equal(cuda, b, lb, lr, k, n_items, t_max):
    rng = np.random.RandomState(b + lb + lr)
    arrs = [rng.randint(0, n_items, (b, lb)), rng.randint(0, t_max, (b, lb)),
            rng.rand(b, lb) < 0.8, rng.randint(0, n_items, (b, lr)),
            rng.randint(0, t_max, (b, lr)), rng.rand(b, lr) < 0.8]
    arrs[2][: b // 4] = False                      # rows with no batch side
    t = [torch.from_numpy(np.asarray(a, np.int32)).to(cuda) for a in arrs]
    before = history_merge.launches
    got = history_merge(*t, out_len=k)
    torch.cuda.synchronize()
    assert history_merge.launches == before + 1
    for g, w in zip(got, history_merge_ref(*t, out_len=k)):
        assert torch.equal(g, w)


def test_history_merge_rejects_bad_input(cuda):
    x = torch.zeros((4, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        history_merge(x, x, x, x, x, x, out_len=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,window", [
    (256, 256, 256, 8, 8, 32, 0),      # the ranker's shapes
    (3, 100, 100, 4, 2, 16, 0),
    (3, 77, 77, 4, 1, 64, 16),         # window, MQA, ragged tiles
    (2, 40, 200, 8, 2, 128, 0),        # Sk > Sq (a prefix of keys)
    (256, 64, 320, 8, 8, 32, 0),       # extend: a 64-token suffix
    (2, 130, 130, 2, 2, 128, 33),
])
def test_flash_attention_kernel_vs_plain(cuda, dtype, b, sq, sk, nq, nkv, hd,
                                         window):
    g = torch.Generator(device="cpu").manual_seed(sq * sk + hd)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype) for shape in
               ((b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd)))
    kpos = torch.arange(sk, dtype=torch.int32, device=cuda).expand(b, sk)
    qpos = kpos[:, sk - sq:].contiguous()
    kpos = kpos.contiguous()
    kvalid = torch.ones((b, sk), dtype=torch.bool, device=cuda)
    kvalid[0, : sk // 3] = False          # left padding
    kvalid[-1] = False                    # a row with no attendable key
    before = flash_attention.launches
    got = flash_attention(q, k, v, qpos, kpos, kvalid, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, qpos, kpos, kvalid, window=window)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_rejects_bad_input(cuda):
    q = torch.zeros((1, 8, 2, 24), device=cuda)  # head dim 24 unsupported
    pos = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    ok = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, pos, pos, ok)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,nq,nkv,hd", [
    (256, 384, 8, 8, 32),    # the serving shape
    (16, 384, 8, 2, 64),     # GQA
    (5, 100, 4, 2, 16),      # W not a multiple of the tile
    (5, 77, 8, 1, 128),      # MQA, hd 128
    (3, 33, 16, 1, 32),      # the largest group the kernel takes
])
def test_decode_attention_kernel_vs_plain(cuda, dtype, b, w, nq, nkv, hd):
    """Partial, exactly full and wrapped rings, slots left unstored by
    left-padded prefills, and a row with no live slot."""
    g = torch.Generator(device="cpu").manual_seed(w * hd + nq)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype) for shape in
               ((b, 1, nq, hd), (b, w, nkv, hd), (b, w, nkv, hd)))
    pos = torch.randint(0, 3 * w, (b,), generator=g, dtype=torch.int32)
    pos[:3] = torch.tensor([w // 3, w - 1, w], dtype=torch.int32)[:b]
    stored = torch.rand((b, w), generator=g) < 0.8
    stored[torch.arange(b), (pos % w).long()] = True
    stored[-1] = False
    pos, stored = pos.to(cuda), stored.to(cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, pos, stored)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_ref(q, k, v, pos, stored)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_decode_attention_rejects_bad_input(cuda):
    pos = torch.zeros((2,), dtype=torch.int32, device=cuda)
    ok = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    q = torch.zeros((2, 1, 2, 24), device=cuda)  # head dim 24 unsupported
    with pytest.raises(ValueError):
        decode_attention(q, torch.zeros((2, 8, 2, 24), device=cuda),
                         torch.zeros((2, 8, 2, 24), device=cuda), pos, ok)
    q = torch.zeros((2, 1, 32, 32), device=cuda)  # 32 heads on one KV head
    kv = torch.zeros((2, 8, 1, 32), device=cuda)
    with pytest.raises(ValueError):
        decode_attention(q, kv, kv, pos, ok)
    q = torch.zeros((2, 1, 2, 32), device=cuda)
    kv = torch.zeros((2, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError):                 # int64 positions
        decode_attention(q, kv, kv, pos.long(), ok)


def _ssd_inputs(dev, dtype, b, s, nh, hp, ds, decay=1.0, seed=0):
    """Inputs shaped like test_kernels._ssd_inputs; row 0 left-padded and
    the last row all padding (dt = 0); a random f32 initial state."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn((b, s, nh, hp), generator=g) * 0.5).to(dev, dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, nh), generator=g) - 2.0)
    dt[0, : s // 3] = 0.0
    dt[-1] = 0.0
    A = -torch.exp(torch.randn((nh,), generator=g) * 0.3) * decay
    B, C = ((torch.randn((b, s, ds), generator=g) * 0.3).to(dev, dtype)
            for _ in range(2))
    D = torch.ones((nh,))
    h0 = torch.randn((b, nh, hp, ds), generator=g)
    return (x, dt.to(dev), A.to(dev), B, C, D.to(dev)), h0.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,hp,ds,chunk,decay,init", [
    (4, 256, 48, 64, 128, 256, 1.0, False),  # mamba2-780m prefill
    (4, 64, 48, 64, 128, 256, 1.0, True),    # its inject: chunk 64, a state
    (2, 128, 8, 32, 64, 32, 1.0, False),     # test_kernels' shapes
    (2, 128, 4, 64, 128, 64, 1.0, True),
    (2, 64, 2, 32, 32, 16, 1.0, True),
    (3, 96, 4, 128, 32, 48, 40.0, True),     # 1.5 tiles a chunk; overflow
    (2, 24, 16, 32, 32, 256, 1.0, True),     # reduced mamba2: chunk 24
    (2, 8, 16, 32, 32, 256, 1.0, True),      # its inject: chunk 8
])
def test_ssd_scan_kernel_vs_plain(cuda, dtype, b, s, nh, hp, ds, chunk,
                                  decay, init):
    args, h0 = _ssd_inputs(cuda, dtype, b, s, nh, hp, ds, decay,
                           seed=s * hp + ds)
    h0 = h0 if init else None
    before = ssd_scan.launches
    y, h = ssd_scan(*args, chunk=chunk, init_state=h0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    yw, hw = ssd_chunked(*args, chunk=min(chunk, s), init_state=h0)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(y.float(), yw.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, hw, atol=1e-4, rtol=1e-4)
    want_last = h0[-1] if init else torch.zeros_like(h[-1])
    assert torch.equal(h[-1], want_last)


def test_ssd_scan_rejects_bad_input(cuda):
    (x, dt, A, B, C, D), h0 = _ssd_inputs(cuda, torch.float32, 2, 64, 4,
                                          32, 32)
    bad = [
        dict(dt=dt.to(torch.bfloat16)),                 # dt must be f32
        dict(B=B.to(torch.bfloat16)),                   # B in x's dtype
        dict(x=x.transpose(2, 3).contiguous().transpose(2, 3)),  # strides
        dict(init_state=h0[:, :, :16]),                 # state shape
        dict(init_state=h0.cpu()),                      # another device
        dict(A=A[:2]),
    ]
    for kw in bad:
        args = dict(x=x, dt=dt, A=A, B=B, C=C, D=D)
        init = kw.pop("init_state", None)
        args.update(kw)
        with pytest.raises(ValueError):
            ssd_scan(*args.values(), chunk=32, init_state=init)
    with pytest.raises(ValueError):                      # chunk 48 of 64
        ssd_scan(x, dt, A, B, C, D, chunk=48)
    with pytest.raises(ValueError):                      # head_dim 16
        ssd_scan(x[..., :16].contiguous(), dt, A, B, C, D)
    with pytest.raises(ValueError):                      # d_state 256
        big = torch.zeros((2, 64, 256), device=cuda)
        ssd_scan(x, dt, A, big, big, D)
    xs = torch.zeros((1, 512, 4, 32), device=cuda)       # chunk 512
    bs = torch.zeros((1, 512, 32), device=cuda)
    with pytest.raises(ValueError):
        ssd_scan(xs, torch.zeros((1, 512, 4), device=cuda), A, bs, bs, D,
                 chunk=512)
