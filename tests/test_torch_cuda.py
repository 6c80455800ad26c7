"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. Run them on the
machine with the card (no JAX needed there):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

``history_merge`` must be bit-equal to its plain version. ``flash_attention``
must be within ``tests/test_kernels.py``'s tolerances: 2e-5 in fp32
(different summation order), 3e-2 in bf16 (the plain version rounds the
probabilities to bf16 before the PV product, the kernel keeps them f32).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.history_merge.ops import history_merge
from repro_torch.kernels.history_merge.ref import history_merge_ref

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
