"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. Run them on the
machine with the card (no JAX needed there):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

``history_merge`` must be bit-equal to its plain version.
``flash_attention`` and ``decode_attention`` must be within
``tests/test_kernels.py``'s tolerances: 2e-5 in fp32 (different summation
order), 3e-2 in bf16 (the plain versions round the normalised
probabilities to bf16 before the PV product; ``flash_attention`` rounds
its unnormalised ones, ``decode_attention`` keeps them f32). ``ssd_scan``'s
y must be within the same tolerances of ``ssd_chunked`` (another summation
order; bf16 rounds y once), its f32 final state within 1e-4, and a row
that is all padding (dt = 0) must keep its incoming state bit for bit.
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


def test_history_merge_kernel_int32_extremes(cuda):
    """Timestamps at int32's ends and around 0, where the kernel's packed
    key flips the sign bit (INT_MIN at index 0 packs to the key 0)."""
    rng = np.random.RandomState(7)
    b, lb, lr, k = 32, 100, 30, 64
    ends = np.array([np.iinfo(np.int32).min, np.iinfo(np.int32).min + 1, -1,
                     0, 1, np.iinfo(np.int32).max], np.int32)
    arrs = [rng.randint(0, 20, (b, lb)), ends[rng.randint(0, 6, (b, lb))],
            rng.rand(b, lb) < 0.8, rng.randint(0, 20, (b, lr)),
            ends[rng.randint(0, 6, (b, lr))], rng.rand(b, lr) < 0.8]
    arrs[0][:, 0], arrs[1][:, 0], arrs[2][:, 0] = 99, ends[0], True
    t = [torch.from_numpy(np.asarray(a, np.int32)).to(cuda) for a in arrs]
    got = history_merge(*t, out_len=k)
    torch.cuda.synchronize()
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


def _flash_case(case, dev, dtype):
    """Inputs that exercise the kernel's tile skip and dead-row mean."""
    b, sq, sk, nq, nkv, hd, window = {
        "all rows dead": (4, 48, 80, 4, 2, 32, 0),
        "non-monotone positions": (3, 70, 70, 4, 2, 64, 0),
        "hd 128, K/V streamed": (2, 64, 1024, 8, 2, 128, 0),
        "window kills interior tiles": (2, 512, 512, 4, 4, 64, 40),
        "extend, invalid suffix tail": (256, 64, 320, 8, 8, 32, 0),
    }[case]
    g = torch.Generator(device="cpu").manual_seed(len(case))
    q, k, v = (torch.randn(shape, generator=g) for shape in
               ((b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd)))
    kpos = torch.arange(sk, dtype=torch.int32).repeat(b, 1)
    qpos = kpos[:, sk - sq:].clone()
    kvalid = torch.ones((b, sk), dtype=torch.bool)
    if case == "all rows dead":
        kvalid[:] = False
    elif case == "non-monotone positions":
        for r in range(b):                       # one permutation per row
            perm = torch.randperm(sk, generator=g).to(torch.int32)
            kpos[r], qpos[r] = perm, perm
        kvalid[1, torch.randperm(sk, generator=g)[: sk // 2]] = False
    elif case == "hd 128, K/V streamed":
        kvalid[0, : sk - 40] = False             # left padding, dead rows
    elif case == "extend, invalid suffix tail":
        # a 256-slot prefix, left-padded, then a 64-token suffix whose
        # real tokens start at each row's next position
        hist = torch.randint(0, 257, (b,), generator=g)
        fresh = torch.randint(0, 9, (b,), generator=g)
        hist[0], fresh[1] = 0, 0
        hist[2], fresh[2] = 0, 0                 # a row with no live key
        slot = torch.arange(sk - sq)
        kvalid[:, : sk - sq] = slot[None] >= (sk - sq - hist)[:, None]
        kvalid[:, sk - sq:] = torch.arange(sq)[None] < fresh[:, None]
        qpos = (sk - sq) + torch.arange(sq, dtype=torch.int32).repeat(b, 1)
        kpos[:, sk - sq:] = qpos
    return [t.to(dev) for t in (q.to(dtype), k.to(dtype), v.to(dtype),
                                 qpos.contiguous(), kpos.contiguous(),
                                 kvalid)], window


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    "all rows dead", "non-monotone positions", "hd 128, K/V streamed",
    "window kills interior tiles", "extend, invalid suffix tail"])
def test_flash_attention_kernel_skip_and_dead_rows(cuda, dtype, case):
    """Cases where whole key tiles are dead or rows have no live key: the
    kernel must still give the plain version's result, and a row with no
    live key must get the mean of V over all keys of its KV head."""
    args, window = _flash_case(case, cuda, dtype)
    q, k, v, qpos, kpos, kvalid = args
    before = flash_attention.launches
    got = flash_attention(*args, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(*args, window=window)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if case == "all rows dead":
        mean = v.float().mean(1).repeat_interleave(q.shape[2] // k.shape[2],
                                                    1)
        torch.testing.assert_close(
            got.float(), mean[:, None].expand_as(got).to(dtype).float(),
            atol=tol, rtol=tol)


def test_flash_attention_rejects_bad_input(cuda):
    q = torch.zeros((1, 8, 2, 24), device=cuda)  # head dim 24 unsupported
    pos = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    ok = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, pos, pos, ok)


def _sparse_layout(kind, b, w, seed):
    """(pos, stored) on the CPU. path: the token path's rows, a left-padded
    prefill of 2W/3 slots with a stored tail, a left-padded inject of W/6
    slots with a few stored, then decode tokens, ~10% of the ring live;
    one live: a single live slot a row; fully live: wrapped, all stored."""
    rng = np.random.RandomState(seed)
    slot = np.arange(w)[None]
    if kind == "path":
        pre, inj = 2 * w // 3, w // 6
        hist = np.minimum(rng.geometric(1 / 32, b), pre)[:, None]
        fresh = rng.randint(0, 9, b)[:, None]
        pos = pre + inj + rng.randint(0, min(10, w - pre - inj), b)
        stored = ((slot >= pre - hist) & (slot < pre)) \
            | ((slot >= pre + inj - fresh) & (slot < pre + inj)) \
            | ((slot >= pre + inj) & (slot <= pos[:, None])) \
            | ((slot > pos[:, None]) & (rng.rand(b, w) < 0.5))
    elif kind == "one live":
        pos = rng.randint(0, w, b)
        stored = slot == (rng.randint(0, w, b) % (pos + 1))[:, None]
        stored[:, w - 1] |= pos < w - 1  # past pos: dead
    else:
        pos = w + rng.randint(0, 2 * w, b)
        stored = np.ones((b, w), bool)
    return (torch.from_numpy(pos.astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(stored)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,nq,nkv,hd,layout", [
    pytest.param(256, 384, 8, 8, 32, "random", id="256-384-8-8-32"),  # serving
    pytest.param(16, 384, 8, 2, 64, "random", id="16-384-8-2-64"),    # GQA
    pytest.param(5, 100, 4, 2, 16, "random", id="5-100-4-2-16"),      # ragged
    pytest.param(5, 77, 8, 1, 128, "random", id="5-77-8-1-128"),      # MQA
    pytest.param(3, 33, 16, 1, 32, "random", id="3-33-16-1-32"),      # g = 16
    pytest.param(256, 384, 8, 8, 32, "path", id="256-384-8-8-32-path"),
    pytest.param(16, 384, 8, 2, 64, "path", id="16-384-8-2-64-path"),
    pytest.param(256, 384, 8, 8, 32, "one live",
                 id="256-384-8-8-32-one-live"),
    pytest.param(5, 77, 8, 1, 128, "one live", id="5-77-8-1-128-one-live"),
    pytest.param(256, 384, 8, 8, 32, "fully live",
                 id="256-384-8-8-32-fully-live"),
    pytest.param(3, 2100, 16, 1, 32, "fully live",
                 id="3-2100-16-1-32-fully-live"),
])
def test_decode_attention_kernel_vs_plain(cuda, dtype, b, w, nq, nkv, hd,
                                          layout):
    """Partial, exactly full and wrapped rings, slots left unstored by
    left-padded prefills, and a row with no live slot (layout "random");
    the token path's sparse rows, one live slot a row, and a fully live
    ring (``_sparse_layout``)."""
    g = torch.Generator(device="cpu").manual_seed(w * hd + nq)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype) for shape in
               ((b, 1, nq, hd), (b, w, nkv, hd), (b, w, nkv, hd)))
    if layout == "random":
        pos = torch.randint(0, 3 * w, (b,), generator=g, dtype=torch.int32)
        pos[:3] = torch.tensor([w // 3, w - 1, w], dtype=torch.int32)[:b]
        stored = torch.rand((b, w), generator=g) < 0.8
        stored[torch.arange(b), (pos % w).long()] = True
        stored[-1] = False
    else:
        pos, stored = _sparse_layout(layout, b, w, w * hd + nq)
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


def _ssd_inputs(dev, dtype, b, s, nh, hp, ds, decay=1.0, seed=0, pad="ends"):
    """Inputs shaped like test_kernels._ssd_inputs and a random f32 initial
    state. ``pad`` "ends": row 0 left-padded and the last row all padding
    (dt = 0); "lead": every row's first half padding and the last row all
    padding; "none": every position live."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn((b, s, nh, hp), generator=g) * 0.5).to(dev, dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, nh), generator=g) - 2.0)
    if pad == "ends":
        dt[0, : s // 3] = 0.0
    if pad == "lead":
        dt[:, : s // 2] = 0.0
    if pad != "none":
        dt[-1] = 0.0
    A = -torch.exp(torch.randn((nh,), generator=g) * 0.3) * decay
    B, C = ((torch.randn((b, s, ds), generator=g) * 0.3).to(dev, dtype)
            for _ in range(2))
    D = torch.ones((nh,))
    h0 = torch.randn((b, nh, hp, ds), generator=g)
    return (x, dt.to(dev), A.to(dev), B, C, D.to(dev)), h0.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,hp,ds,chunk,decay,init,pad", [
    (4, 256, 48, 64, 128, 256, 1.0, False, "ends"),  # mamba2-780m prefill
    (4, 64, 48, 64, 128, 256, 1.0, True, "ends"),    # its inject: chunk 64, a state
    (2, 128, 8, 32, 64, 32, 1.0, False, "ends"),     # test_kernels' shapes
    (2, 128, 4, 64, 128, 64, 1.0, True, "ends"),
    (2, 64, 2, 32, 32, 16, 1.0, True, "ends"),
    (3, 96, 4, 128, 32, 48, 40.0, True, "ends"),     # 3 tiles a chunk; overflow
    (2, 24, 16, 32, 32, 256, 1.0, True, "ends"),     # reduced mamba2: chunk 24
    (2, 8, 16, 32, 32, 256, 1.0, True, "ends"),      # its inject: chunk 8
    (4, 256, 48, 64, 128, 256, 1.0, False, "none"),  # fully live mamba2 prefill
    (2, 512, 48, 64, 128, 256, 1.0, True, "ends"),   # two chunks of 256
    (2, 128, 5, 64, 128, 64, 1.0, True, "ends"),     # nh 5: not a whole head block
    (3, 48, 3, 128, 64, 24, 1.0, True, "ends"),      # nh 3, hp 128, chunk 24
    (4, 64, 48, 64, 128, 64, 1.0, True, "lead"),     # inject, leading rows dead
])
def test_ssd_scan_kernel_vs_plain(cuda, dtype, b, s, nh, hp, ds, chunk,
                                  decay, init, pad):
    args, h0 = _ssd_inputs(cuda, dtype, b, s, nh, hp, ds, decay,
                           seed=s * hp + ds, pad=pad)
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
    if pad != "none":
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
