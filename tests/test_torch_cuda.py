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
The paged state pool's gather and scatter must copy every leaf bit for
bit on the card, and a pooled Gateway there must serve what a host-LRU
one does, bit for bit. The reduced frontend archs with prefix embeddings
and the step layer's three kinds must give on the card what they give on
the CPU (within 1e-4 at fp32), and the donating train step must be bit
for bit the functional one there too.
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


def test_gateway_cuda_matches_cpu(cuda):
    """The port's Gateway on the card against the same Gateway on the CPU,
    tiny width, fp32, over a warm pass, a hit wave (inject from the host
    LRU) and a miss wave (prefill): equal paths and slates, first logits
    within 1e-4; the card's panes launch the two attention kernels."""
    from repro_torch.configs import ModelConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving import (Gateway, Request, ServerConfig,
                                     ServingConfig, ServingEngine)
    from torch_port import make_injector

    from conftest import DAY, N_ITEMS
    cfg = ModelConfig(name="tiny-test", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=N_ITEMS + 256, rope_theta=1e4,
                      tie_embeddings=True)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    scfg = ServingConfig(max_batch=4, prefill_len=32, inject_len=8,
                         cache_capacity=64)
    now = 5 * DAY + 100
    out = {}
    for dev in ("cpu", cuda):
        gw = Gateway(ServingEngine(cfg, params, scfg, device=dev),
                     make_injector("repro_torch", device=dev),
                     ServerConfig(slate_len=3, cache_entries=64))
        gw.observe_many(np.arange(16), np.arange(16) + 7,
                        np.full(16, now - 20))
        flash_attention.launches = decode_attention.launches = 0
        assert gw.warm(np.arange(8), now) == 8
        tickets = []
        for users in (np.arange(8), np.arange(8, 16)):
            tickets += gw.submit_many([Request(user=int(u), now=now)
                                       for u in users])
            gw.flush(now)
        out[str(dev)] = (tickets, flash_attention.launches,
                         decode_attention.launches)
    (cpu, _, _), (gpu, fa, da) = out["cpu"], out[str(cuda)]
    assert fa > 0 and da > 0
    assert [t.response.telemetry.path for t in gpu] == \
        ["inject"] * 8 + ["prefill"] * 8
    for c, g in zip(cpu, gpu):
        assert g.response.telemetry.path == c.response.telemetry.path
        np.testing.assert_array_equal(g.response.slate, c.response.slate)
        np.testing.assert_allclose(g.response.scores, c.response.scores,
                                   atol=1e-4, rtol=1e-4)


def _tiny_cuda_engine(cuda, arch="tiny-test", dtype=torch.float32):
    from repro_torch.configs import ModelConfig, get_config, reduced
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    from conftest import N_ITEMS
    if arch in ("mamba2", "granite"):
        cfg = reduced(get_config({"mamba2": "mamba2-780m",
                                  "granite": "granite-moe-3b-a800m"}[arch]))
    else:
        cfg = ModelConfig(name="tiny-test", family="dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                          vocab_size=N_ITEMS + 256, rope_theta=1e4,
                          tie_embeddings=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype, "cpu")
    return ServingEngine(cfg, params, ServingConfig(
        max_batch=4, prefill_len=32, inject_len=8, cache_capacity=64),
        device=cuda)


@pytest.mark.parametrize("arch", ["tiny-test", "mamba2"])
def test_state_pool_roundtrip_cuda(cuda, arch):
    """The pool's gather and scatter on the card: every leaf (K/V or the
    SSM conv tails and f32 state, bool ``valid``, int32 ``next_pos``,
    the last logits) bit for bit, untouched slots still zero, and a
    gathered pane that shares no storage with the pool."""
    from repro_torch.serving import DeviceStatePool

    eng = _tiny_cuda_engine(cuda, arch)
    rng = np.random.RandomState(0)
    seqs = [rng.randint(1, 300, rng.randint(4, 20)).tolist()
            for _ in range(4)]
    state = eng.prefill(*eng.pad_tokens(seqs, 32))
    pool = DeviceStatePool(eng, 8)
    pool.scatter(state, [5, 0, 7, 2])
    got, last = pool.gather([5, 0, 7])
    idx = torch.tensor([0, 1, 2, 0], device=cuda)
    flat = [(g, s) for g, s in zip(_tree_leaves(got["caches"]),
                                   _tree_leaves(state["caches"]))]
    for g, s in flat:
        assert g.device.type == cuda.type and torch.equal(g, s[:, idx])
    assert got["valid"].dtype == torch.bool
    assert got["next_pos"].dtype == torch.int32
    assert torch.equal(got["valid"], state["valid"][idx])
    assert torch.equal(got["next_pos"], state["next_pos"][idx])
    assert torch.equal(last, state["logits"][idx, -1])
    for x in _tree_leaves(pool.caches):
        assert not x[:, [1, 3, 4, 6]].any()
        assert not any(g.data_ptr() == x.data_ptr() for g, _ in flat)


def _tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tree_leaves(v)
        else:
            yield v


def test_pooled_gateway_cuda_matches_host_lru(cuda):
    """A ``tiny-test`` Gateway on the card with the paged state pool and
    one with the host LRU, fp32, over a warm pass, a hit wave, a miss
    wave and a wave that evicts under slot pressure: equal paths, slates
    and scores, bit for bit."""
    from repro_torch.serving import Gateway, Request, ServerConfig
    from torch_port import make_injector

    from conftest import DAY
    eng = _tiny_cuda_engine(cuda)
    now = 5 * DAY + 100
    out = []
    for kw in (dict(pool_slots=12), dict(cache_entries=12)):
        gw = Gateway(eng, make_injector("repro_torch", device=cuda),
                     ServerConfig(slate_len=3, **kw))
        gw.observe_many(np.arange(16), np.arange(16) + 7,
                        np.full(16, now - 20))
        assert gw.warm(np.arange(8), now) == 8
        tickets = []
        for users in (np.arange(8), np.arange(8, 16), np.arange(4, 12)):
            tickets += gw.submit_many([Request(user=int(u), now=now)
                                       for u in users])
            gw.flush(now)
        out.append((tickets, gw.cache.stats()))
    (pooled, pst), (host, hst) = out
    assert pst["evictions"] == hst["evictions"] > 0
    assert [t.response.telemetry.path for t in pooled][:16] == \
        ["inject"] * 8 + ["prefill"] * 8
    for p, h in zip(pooled, host):
        assert p.response.telemetry.path == h.response.telemetry.path
        np.testing.assert_array_equal(p.response.slate, h.response.slate)
        np.testing.assert_array_equal(p.response.scores, h.response.scores)


def _slate_state(eng, seed=0):
    """prefill -> inject of a seeded pane: (state, first logits)."""
    rng = np.random.RandomState(seed)
    b = eng.scfg.max_batch
    hist = [rng.randint(1, 300, rng.randint(4, 30)).tolist() for _ in range(b)]
    fresh = [rng.randint(1, 300, rng.randint(0, 8)).tolist() for _ in range(b)]
    pre = eng.prefill(*eng.pad_tokens(hist, eng.scfg.prefill_len))
    st = eng.inject(pre, *eng.pad_tokens(fresh, eng.scfg.inject_len,
                                         align="left"),
                    fallback_logits=pre["logits"][:, -1])
    return st, st["first_logits"]


@pytest.mark.parametrize("arch,dtype", [
    ("tiny-test", torch.float32), ("tiny-test", torch.bfloat16),
    ("mamba2", torch.float32), ("mamba2", torch.bfloat16)])
def test_slate_graph_equals_loop(cuda, arch, dtype):
    """``decode_slate`` on the card (one replay of a captured graph) is bit
    for bit the eager loop's slate, on the capture call and on replays
    with other panes, with and without ``row_lens``; neither touches the
    state it was given."""
    eng = _tiny_cuda_engine(cuda, arch, dtype)
    for seed in range(3):
        st, first = _slate_state(eng, seed)
        before = [t.clone() for t in _tree_leaves(st["caches"])]
        want = eng._decode_slate_loop(st, first, 5)
        got = eng.decode_slate(st, first, 5)
        np.testing.assert_array_equal(got, want)
        lens = np.array([5, 1, 3, 0], np.int32)
        np.testing.assert_array_equal(
            eng.decode_slate(st, first, 5, row_lens=lens),
            eng._decode_slate_loop(st, first, 5, row_lens=lens))
        for t, b in zip(_tree_leaves(st["caches"]), before):
            assert torch.equal(t, b)
    assert len(eng.slate_graph_stats()) == 1


def test_slate_graph_counts_launches_under_replay(cuda):
    """A replay runs no wrapper code, so the graph adds its captured
    launches at each replay: every ``decode_slate`` call counts what the
    eager loop counts, n_layers x (slate_len - 1) ``decode_attention``."""
    from repro_torch.kernels import launch_counters
    eng = _tiny_cuda_engine(cuda)
    st, first = _slate_state(eng)
    per_slate = eng.cfg.n_layers * (5 - 1)
    ops = launch_counters()
    before = {n: op.launches for n, op in ops.items()}
    eng._decode_slate_loop(st, first, 5)
    assert decode_attention.launches - before["decode_attention"] == \
        per_slate
    eng.decode_slate(st, first, 5)           # warm-up run + first replay
    (stats,) = eng.slate_graph_stats().values()
    assert stats.launches == {"decode_attention": per_slate}
    assert decode_attention.launches - before["decode_attention"] == \
        3 * per_slate
    for _ in range(4):
        eng.decode_slate(st, first, 5)
    assert decode_attention.launches - before["decode_attention"] == \
        7 * per_slate
    for name in ("flash_attention", "ssd_scan", "history_merge"):
        assert ops[name].launches == before[name]


def test_slate_lengths_share_ring_buffers(cuda):
    """Every slate length's graph of one pane shape captures over the same
    ring buffers and one memory pool: after the first graph, seven more
    lengths grow neither the device memory in use nor its peak by an
    eighth of the rings' bytes (a copy of the rings per length would
    grow both by the whole), and each slate is the first picks of the
    longest loop's (greedy decode is prefix-stable)."""
    from repro_torch.serving import ServingConfig, ServingEngine
    small = _tiny_cuda_engine(cuda)
    eng = ServingEngine(small.cfg, small.params, ServingConfig(
        max_batch=16, prefill_len=32, inject_len=8, cache_capacity=4096),
        device=cuda)
    st, first = _slate_state(eng)
    want = eng._decode_slate_loop(st, first, 9)
    np.testing.assert_array_equal(eng.decode_slate(st, first, 2),
                                  want[:, :2])
    (stats,) = eng.slate_graph_stats().values()
    assert stats.ring_bytes >= 32 << 20
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.decode_slate(st, first, 2)
    now, peak = torch.cuda.memory_allocated(), \
        torch.cuda.max_memory_allocated()
    for n in range(3, 10):
        np.testing.assert_array_equal(eng.decode_slate(st, first, n),
                                      want[:, :n])
    assert len(eng.slate_graph_stats()) == 8
    assert torch.cuda.memory_allocated() - now < stats.ring_bytes / 8
    assert torch.cuda.max_memory_allocated() - peak < stats.ring_bytes / 8


def test_patch_after_warm_graph_equals_cold_engine(cuda):
    """A patch installed after the graph is warm: the next replay serves
    bit for bit what a cold engine built from the patched weights serves,
    through its own graph and its loop."""
    from repro_torch.models.common import flatten_with_keystr
    from repro_torch.serving import ServingEngine
    eng = _tiny_cuda_engine(cuda)
    st, first = _slate_state(eng)
    old = eng.decode_slate(st, first, 5)               # the graph is warm
    rng = np.random.RandomState(5)
    eng.apply_patch({k: v.cpu() + torch.from_numpy(
        rng.randn(*v.shape).astype(np.float32)) * 0.5
        for k, v in flatten_with_keystr(eng.params)
        if "embed" in k or "['wo']" in k})
    st, first = _slate_state(eng)
    got = eng.decode_slate(st, first, 5)
    assert len(eng.slate_graph_stats()) == 1
    cold = ServingEngine(eng.cfg, eng.params, eng.scfg, device=cuda)
    cst, cfirst = _slate_state(cold)
    np.testing.assert_array_equal(got, cold._decode_slate_loop(cst, cfirst,
                                                               5))
    np.testing.assert_array_equal(got, cold.decode_slate(cst, cfirst, 5))
    assert not np.array_equal(old, got)


def test_trainer_worker_runs_while_graphs_capture(cuda):
    """The online trainer's worker trains on the card from its own thread
    while the serving thread captures new slate graphs and replays them:
    no capture error, every slate equals the eager loop's, and the worker
    stepped and stops cleanly."""
    from repro_torch.core.event_log import EventLog
    from repro_torch.training import (AdamWConfig, OnlineTrainer,
                                      OnlineTrainerConfig, TrainConfig)
    eng = _tiny_cuda_engine(cuda)
    log = EventLog(n_users=64)
    rng = np.random.RandomState(0)
    feed = {"t": 1000}

    def more_events():
        for _ in range(32):
            log.append(int(rng.randint(64)), int(rng.randint(300)),
                       feed["t"])
            feed["t"] += 1
    more_events()
    tr = OnlineTrainer(eng.cfg, eng.params, log, device=cuda,
                       cfg=OnlineTrainerConfig(batch_size=32, seq_len=32,
                                               interval_s=0.0),
                       train_cfg=TrainConfig(adamw=AdamWConfig(lr=1e-3),
                                             remat=False,
                                             param_dtype=torch.float32),
                       step_hook=more_events)
    tr.start()
    try:
        for slate_len in range(2, 9):
            st, first = _slate_state(eng, slate_len)
            want = eng._decode_slate_loop(st, first, slate_len)
            for _ in range(2):
                np.testing.assert_array_equal(
                    eng.decode_slate(st, first, slate_len), want)
    finally:
        tr.stop(timeout=120)
    assert not tr._thread.is_alive()
    assert tr.steps >= 1 and tr.poll_patch() is not None
    assert len(eng.slate_graph_stats()) == 7


# ----------------------------------------------------------------------
# The A/B harness on the card
# ----------------------------------------------------------------------

def _ranker_attention_inputs(dev, dtype, b, s, heads, hd, seed):
    """The ranker's attention at the A/B's shapes: left-padded history
    validity with lengths spread over [0, S], one row with no valid key."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, s, heads, hd), generator=g).to(dev, dtype)
               for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    lengths = torch.randint(0, s + 1, (b,), generator=g).to(dev)
    lengths[0] = 0
    kvalid = pos >= (s - lengths)[:, None]
    return q, k, v, pos.contiguous(), pos.contiguous(), kvalid.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_ab_shapes(cuda, dtype):
    """``flash_attention`` at the A/B ranker's shape (B 256, S 48, 8 heads
    of 32) within the kernel tolerances, and ``history_merge`` at the
    treatment arm's (Lb = K = 48, Lr = 16) bit for bit."""
    args = _ranker_attention_inputs(cuda, dtype, 256, 48, 8, 32, seed=48)
    before = flash_attention.launches
    got = flash_attention(*args)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), attention_ref(*args).float(),
                               atol=tol, rtol=tol)
    rng = np.random.RandomState(16)
    for b in (256, 37):
        arrs = [rng.randint(0, 4864, (b, 48)), rng.randint(0, 10**6, (b, 48)),
                rng.rand(b, 48) < 0.7, rng.randint(0, 4864, (b, 16)),
                rng.randint(5 * 10**5, 10**6, (b, 16)), rng.rand(b, 16) < 0.5]
        arrs[3][:, ::3] = arrs[0][:, :16][:, ::3]      # re-watched items
        t = [torch.from_numpy(np.asarray(a, np.int32)).to(cuda)
             for a in arrs]
        for g, w in zip(history_merge(*t, out_len=48),
                        history_merge_ref(*t, out_len=48)):
            assert torch.equal(g, w)


def _ab_micro(**kw):
    from repro_torch.core.ab import ABConfig
    from repro_torch.data.synthetic import WorldConfig
    base = dict(world=WorldConfig(n_users=50, n_items=250,
                                  sessions_per_day=1.5, seed=0),
                bootstrap_days=2, gen1_days=1, ab_days=2, feature_len=24,
                train_epochs=1, train_batch=32, max_examples=1500,
                latency_arms=(3600,))
    return ABConfig(**{**base, **kw})


def test_run_experiment_cuda_micro(cuda):
    """The whole experiment on the card at the integration test's scale:
    every arm present, identical impressions user by user (common random
    numbers), and a second run bit for bit the first."""
    from repro_torch.core.ab import run_experiment
    runs = [run_experiment(_ab_micro(), log=None, device=cuda)
            for _ in range(2)]
    for rep in runs:
        assert set(rep["arms"]) == {"control", "treatment", "consistent",
                                    "stale_3600s"}
        ui = [r.user_impressions for r in rep["results"].values()]
        for x in ui[1:]:
            np.testing.assert_array_equal(x, ui[0])
        for a in rep["arms"].values():
            assert 0.0 < a["ctr"] < 0.9
    assert runs[0]["arms"] == runs[1]["arms"]
    assert runs[0]["tests"] == runs[1]["tests"]
    for name, res in runs[0]["results"].items():
        other = runs[1]["results"][name]
        assert res.day_metrics == other.day_metrics
        np.testing.assert_array_equal(res.user_watches, other.user_watches)


@pytest.mark.parametrize("mode", ["plain", "consistent"])
def test_ab_serve_kernel_vs_plain_fp32(cuda, mode):
    """One serve call of every user at fp32: the kernel path (the ranker's
    ``flash_attention``, the treatment's ``history_merge``) against the
    plain path on the same card. The tokens are equal, and a slate may
    differ only on a row whose top candidate scores tie within 1e-4."""
    from unittest import mock

    from repro_torch.core import injection as injection_mod
    from repro_torch.core import pipeline as pipeline_mod
    from repro_torch.core.ab import default_sim_model, make_platform
    from repro_torch.data.synthetic import (World, bootstrap_serve_fn,
                                            simulate_day)
    from repro_torch.models import attention as attention_mod
    from repro_torch.models.model import init_params

    ab = _ab_micro()
    world = World(ab.world)
    serve0 = bootstrap_serve_fn(world, 0)
    events = []
    for day in range(3):
        events += simulate_day(world, day, serve0, lambda e: None, seed=0)[0]
    cfg = default_sim_model(ab.world.n_items)
    params = init_params(cfg, torch.Generator().manual_seed(1),
                         torch.float32, cuda)
    plat = make_platform(ab, cfg, params, world, events, policy="inject",
                         mode=mode, device=cuda)
    users = np.arange(ab.world.n_users)
    tss = np.full(len(users), 3 * 86400 + 6 * 3600)
    seen = []
    real = pipeline_mod._serve_core

    def spy(ranker, tokens, valid, pop, **kw):
        out = real(ranker, tokens, valid, pop, **kw)
        last = ranker(tokens.long(), valid=valid > 0, last_only=True)[:, -1]
        seen.append((tokens.clone(), out[0], out[1], last))
        return out
    with mock.patch.object(pipeline_mod, "_serve_core", spy):
        merges = plat.injector.merge_calls
        before = (flash_attention.launches, history_merge.launches)
        plat.serve(users, tss)
        assert flash_attention.launches > before[0]
        assert (history_merge.launches > before[1]) == (mode == "plain")
        assert (plat.injector.merge_calls > merges) == (mode == "plain")
        with mock.patch.object(attention_mod, "flash_attention",
                               attention_ref), \
                mock.patch.object(injection_mod, "history_merge",
                                  history_merge_ref):
            plat.serve(users, tss)
    (k_tok, k_slate, k_cand, k_last), (p_tok, p_slate, p_cand, p_last) = seen
    assert torch.equal(k_tok, p_tok) and torch.equal(k_cand, p_cand)
    torch.testing.assert_close(k_last, p_last, atol=1e-4, rtol=1e-4)
    differ = (k_slate != p_slate).any(1)
    if differ.any():
        c = p_cand.shape[1]
        dup = ((p_cand[:, :, None] == p_cand[:, None, :]) & torch.ones(
            c, c, dtype=torch.bool, device=cuda).tril(-1)).any(-1)
        scores = torch.gather(p_last, 1, p_cand + 1).masked_fill(dup, -1e9)
        top = scores[differ].sort(1, descending=True).values[:, :11]
        assert ((top[:, :-1] - top[:, 1:]).min(1).values <= 1e-4).all()


# ----------------------------------------------------------------------
# the MoE layer and the scenario harness
# ----------------------------------------------------------------------

def test_moe_apply_cuda_matches_cpu(cuda):
    """``moe_apply`` on the card against its CPU result at fp32, within
    1e-5, on rows that overflow capacity (drops), with exact router ties
    and at one token a row."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.moe import init_moe, moe_apply

    cfg = reduced(get_config("granite-moe-3b-a800m"), d_model=64)
    params = init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                      "cpu")
    params["router"][:, 2] = params["router"][:, 1]
    rng = np.random.RandomState(0)
    for shape in ((3, 24, 64), (5, 1, 64)):
        x = torch.from_numpy(np.abs(rng.randn(*shape)).astype(np.float32))
        x[0, :3] = 0.0
        y, aux = moe_apply(params, x, cfg)
        gy, gaux = moe_apply({k: v.to(cuda) for k, v in params.items()},
                             x.to(cuda), cfg)
        np.testing.assert_allclose(gy.cpu().numpy(), y.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(gaux.cpu().numpy(), aux.numpy(),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_slate_graph_equals_loop(cuda, dtype):
    """A reduced MoE stack's ``decode_slate`` graph (sort, stable argsort,
    cummax and scatters captured) is bit for bit its eager loop."""
    eng = _tiny_cuda_engine(cuda, "granite", dtype)
    for seed in range(3):
        st, first = _slate_state(eng, seed)
        want = eng._decode_slate_loop(st, first, 5)
        np.testing.assert_array_equal(eng.decode_slate(st, first, 5), want)
    assert len(eng.slate_graph_stats()) == 1


def test_scenario_cuda_counters_match_cpu(cuda):
    """``run_scenario`` of churn_heavy (smoke) at the harness's own fp32
    engine on the card and on the CPU: the same trace, every sim-time
    metric, gate verdict and counter equal, and every gate passes on the
    card (the CPU run's wall-clock gates are the host's business)."""
    from repro_torch.serving import loadgen

    spec = loadgen.get_scenario("churn_heavy", smoke=True)
    (gpu,) = loadgen.run_scenario(spec, device=cuda)
    (cpu,) = loadgen.run_scenario(spec, device="cpu")
    wall = ("wall_ms_p99", "boundary_slice_max_ms")
    assert gpu.trace_fingerprint == cpu.trace_fingerprint
    assert {k: v for k, v in gpu.metrics.items() if k not in wall} == \
        {k: v for k, v in cpu.metrics.items() if k not in wall}
    assert gpu.slo_pass
    assert all(g["pass"] for g in cpu.gates
               if not g["gate"].startswith(("wall", "boundary")))
    g, c = gpu.gateway_stats, cpu.gateway_stats
    for d in (g, c):
        d.pop("patch_install_max_ms")
        for key in ("build_time_s", "build_slice_max_s"):
            d["rollover"].pop(key)
    assert g == c


# ----------------------------------------------------------------------
# the frontend archs and the one-device step layer
# ----------------------------------------------------------------------

def _frontend_model(arch, dev):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_params

    cfg = reduced(get_config(arch), d_model=64)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    return cfg, params, {k: _to(v, dev) for k, v in params.items()}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
def test_frontend_prefill_decode_cuda_matches_cpu(cuda, arch):
    """A reduced frontend arch at fp32 with 4 prefix embeddings: prefill
    through ``flash_attention`` and two decode steps through
    ``decode_attention`` on the card, against the plain versions on the
    CPU (logits within 1e-4, equal greedy tokens), each kernel launched
    once a layer."""
    from repro_torch.models.model import (cache_from_prefill, decode_step,
                                          prefill)

    cfg, params, gparams = _frontend_model(arch, cuda)
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, (2, 20)).astype(
        np.int32))
    pfx = torch.from_numpy((rng.standard_normal((2, 4, cfg.d_model))
                            * 0.02).astype(np.float32))
    f0, d0 = flash_attention.launches, decode_attention.launches
    log, c = prefill(params, cfg, toks, prefix_embeds=pfx)
    glog, gc = prefill(gparams, cfg, toks.to(cuda),
                       prefix_embeds=pfx.to(cuda))
    assert flash_attention.launches == f0 + cfg.n_layers
    np.testing.assert_allclose(glog.cpu().numpy(), log.numpy(), atol=1e-4,
                               rtol=1e-4)
    dc, gdc = cache_from_prefill(cfg, c, 32), cache_from_prefill(cfg, gc, 32)
    tok = torch.argmax(log[:, -1], -1).to(torch.int32)[:, None]
    for i in range(2):
        pos = torch.full((2,), 24 + i, dtype=torch.int32)
        lg, dc = decode_step(params, cfg, dc, tok, pos)
        glg, gdc = decode_step(gparams, cfg, gdc, tok.to(cuda), pos.to(cuda))
        np.testing.assert_allclose(glg.cpu().numpy(), lg.numpy(), atol=1e-4,
                                   rtol=1e-4)
        tok = torch.argmax(lg[:, 0], -1).to(torch.int32)[:, None]
        assert torch.equal(torch.argmax(glg[:, 0], -1).cpu().to(torch.int32),
                           tok[:, 0])
    assert decode_attention.launches == d0 + 2 * cfg.n_layers


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_step_layer_cuda_matches_cpu(cuda, kind):
    """``make_step_and_inputs``' three kinds on reduced ``musicgen-large``
    at seq 32, batch 2, in fp32: the example args drawn on the card, run
    there, and the same args run on the CPU (train: metrics and the new
    master within 1e-4; prefill: last logits; decode: tokens)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.steps import make_step_and_inputs

    cfg = reduced(get_config("musicgen-large"), d_model=64)
    shape = InputShape(f"tiny_{kind}", 32, 2, kind)
    step, args = make_step_and_inputs(
        cfg, shape, device=cuda, dtype=torch.float32,
        generator=torch.Generator(device=cuda).manual_seed(0))
    cpu_step, _ = make_step_and_inputs(cfg, shape, device="meta",
                                       dtype=torch.float32)
    want = cpu_step(*_to(args, "cpu"))
    got = step(*args)
    if kind == "train":
        for k in ("loss", "acc", "grad_norm"):
            np.testing.assert_allclose(got[2][k].cpu().numpy(),
                                       want[2][k].numpy(), atol=1e-4,
                                       rtol=1e-4)
        np.testing.assert_allclose(
            got[1].master["embed"]["table"].cpu().numpy(),
            want[1].master["embed"]["table"].numpy(), atol=1e-4, rtol=1e-4)
    elif kind == "prefill":
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                                   atol=1e-4, rtol=1e-4)
    else:
        assert torch.equal(got[0].cpu(), want[0])


def test_donating_train_step_cuda_equals_functional(cuda):
    """One donating train step on the card, bf16 params, bit for bit the
    functional step on the same inputs."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.common import flatten_with_keystr, tree_map
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    cfg = reduced(get_config("musicgen-large"), d_model=64)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         torch.bfloat16, cuda)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-2, warmup_steps=1),
                       remat=True, param_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    toks = rng.randint(1, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fp, fo, fm = make_train_step(cfg, tcfg)(params, init_opt_state(params),
                                            batch)
    dparams = tree_map(lambda t: t.clone(), params)
    dp, do, dm = make_train_step(cfg, tcfg, donate=True)(
        dparams, init_opt_state(dparams), batch)
    for k in fm:
        assert torch.equal(fm[k], dm[k]), k
    for a, b in ((fp, dp), (fo.master, do.master), (fo.m, do.m),
                 (fo.v, do.v)):
        for (path, x), (_, y) in zip(flatten_with_keystr(a),
                                     flatten_with_keystr(b)):
            assert torch.equal(x, y), path


@pytest.fixture
def mesh_1x1(cuda):
    """A 1x1 NCCL mesh in this process (a one-rank process group of its
    own, destroyed after the test)."""
    from repro_torch.launch.mesh import close_mesh, make_serving_mesh
    try:
        yield make_serving_mesh(1, 1, device="cuda")
    finally:
        close_mesh()


@pytest.mark.parametrize("pool", [None, 16], ids=["lru", "pool"])
def test_mesh_1x1_gateway_bitwise_equals_mesh_free(mesh_1x1, pool):
    """The JAX equivalence tool's trace (``tools/torch_sharded_equiv_check``)
    on the card: the Gateway on a 1x1 NCCL mesh serves every response and
    counter of the mesh-free Gateway, bit for bit."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import torch_sharded_equiv_check as tool

    want = tool.port_record(None, pool_slots=pool, device="cuda")
    got = tool.port_record(mesh_1x1, pool_slots=pool, device="cuda")
    for a, b in zip(want["waves"], got["waves"]):
        np.testing.assert_array_equal(a["slates"], b["slates"])
        np.testing.assert_array_equal(a["scores"], b["scores"])
        assert a["hits"] == b["hits"]
    assert want["stats"] == got["stats"]
    assert want["rollover"] == got["rollover"]


def test_mesh_1x1_engine_slate_graph(mesh_1x1):
    """A 1x1 mesh's engine on the card captures its slate graph (no model
    collectives), which serves its eager loop's slate and the mesh-free
    engine's, bit for bit."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = reduced(get_config("itfi-ranker"))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cuda")
    scfg = ServingConfig(max_batch=8, prefill_len=32, inject_len=8,
                         cache_capacity=48)
    plain = ServingEngine(cfg, params, scfg, device="cuda")
    eng = ServingEngine(cfg, params, scfg, device="cuda", mesh=mesh_1x1)
    assert eng.graph_slates and eng.data_shards == 1
    rng = np.random.RandomState(0)
    toks, valid = eng.pad_tokens([list(rng.randint(1, 500, 20))
                                  for _ in range(8)], 32)
    stoks, svalid = eng.pad_tokens([list(rng.randint(1, 500, 5))
                                    for _ in range(8)], 8, align="left")
    out = []
    for e in (plain, eng):
        st = e.prefill(toks, valid, logits_last_only=True)
        st = e.inject(st, stoks, svalid, fallback_logits=st["logits"][:, -1])
        out.append((e.decode_slate(st, st["first_logits"], 6),
                    e._decode_slate_loop(st, st["first_logits"], 6),
                    st["first_logits"]))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[1][0], out[1][1])
    assert torch.equal(out[0][2], out[1][2])
    assert eng.slate_graph_stats()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_mesh_1x1_step_layer_bitwise_equals_one_device(mesh_1x1, arch, kind):
    """``make_step_and_specs`` on a 1x1 NCCL mesh on the card (reduced, fp32,
    the prefill and decode steps through the kernels): every output bit
    for bit what ``make_step_and_inputs``' one-device step gives."""
    from repro_torch.configs import InputShape, get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.models.common import flatten_with_keystr

    cfg = reduced(get_config(arch), d_model=64)
    shape = InputShape(f"x_{kind}", 64, 2, kind)
    step, args = steps.make_step_and_inputs(cfg, shape, device="cuda",
                                            dtype=torch.float32)
    mstep, margs, _, _ = steps.make_step_and_specs(
        cfg, shape, mesh_1x1, device="cuda", dtype=torch.float32)
    want = flatten_with_keystr(list(step(*args)))
    got = flatten_with_keystr(list(mstep(*margs)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        assert torch.equal(x, y), path
