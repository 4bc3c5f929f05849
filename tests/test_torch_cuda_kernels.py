"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  These tests need an NVIDIA GPU and ``nvcc``: they
are marked ``cuda`` and skip without a card.  This file imports no JAX, so
it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import kernel as t_kernel
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

SHAPES = [  # B, Hq, KVH, hd, page, pages_per_seq
    (2, 8, 2, 64, 128, 4),    # tests/test_kernels.py
    (3, 4, 4, 128, 128, 2),
    (1, 8, 1, 64, 256, 3),
    (8, 8, 4, 32, 16, 4),     # demo engine: G=2
    (4, 16, 2, 32, 16, 3),    # narrow G=8
    (16, 32, 4, 64, 16, 16),  # TinyLlama-1.1B, max_len 256
    (2, 32, 2, 128, 7, 5),    # G=16, odd page size
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(B, Hq, KVH, hd, page, nps, dtype, dev, seed=5):
    """Shuffled disjoint page tables over pages 1.., ragged lengths
    including 1, a page edge and a full table, trash page 0 past each
    row's last page."""
    rng = np.random.RandomState(seed)
    P = B * nps + 2
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, dtype) for s in ((B, Hq, hd), (P, page, KVH, hd),
                                         (P, page, KVH, hd)))
    tables = (rng.permutation(B * nps) + 2).reshape(B, nps).astype(np.int32)
    lens = rng.randint(1, page * nps + 1, size=B)
    lens[:min(B, 4)] = [1, page, page + 1, page * nps][:min(B, 4)]
    for b in range(B):
        tables[b, -(-lens[b] // page):] = 0
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_paged_attention_kernel_matches_ref(card, shape, dtype):
    q, k, v, tables, lens = _inputs(*shape, getattr(torch, dtype), card)
    before = t_kernel.launches
    got = paged_attention(q, k, v, tables, lens)  # auto: CUDA -> kernel
    torch.cuda.synchronize()
    assert t_kernel.launches == before + 1
    want = paged_attention_ref(q, k, v, tables, lens)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    # int64 tables and lengths are converted, not refused
    got64 = paged_attention(q, k, v, tables.long(), lens.long(), impl="cuda")
    torch.testing.assert_close(got64, got, rtol=0, atol=0)


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_bad_inputs(card):
    q, k, v, tables, lens = _inputs(2, 8, 4, 32, 16, 2, torch.float32, card)
    with pytest.raises(TypeError):
        paged_attention(q.half(), k.half(), v.half(), tables, lens,
                        impl="cuda")
    with pytest.raises(ValueError):
        paged_attention(q, k[..., :16].contiguous(), v[..., :16].contiguous(),
                        tables, lens, impl="cuda")
