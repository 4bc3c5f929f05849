"""The port's hand-written CUDA kernels (paged decode attention, flash
attention forward, batched LoRA) against their plain PyTorch versions, on
the card.  These tests need an NVIDIA GPU and ``nvcc``: they
are marked ``cuda`` and skip without a card.  This file imports no JAX, so
it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.batched_lora import kernel as lora_kernel
from repro_torch.kernels.batched_lora.ops import batched_lora, pack_segments
from repro_torch.kernels.batched_lora.ref import batched_lora_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import kernel as t_kernel
from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_decode_step,
    write_token_to_pages,
)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def bf16_ulp_err(got, want):
    """Largest |got - want| in bf16 ulps of ``want`` (1e-5 at least)."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.ldexp(torch.ones_like(w), e - 8))
    return float(((got.float() - w).abs() / ulp.clamp_min(1e-5)).max())
LORA_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
            "bfloat16": dict(rtol=5e-2, atol=5e-2)}

SHAPES = [  # B, Hq, KVH, hd, page, pages_per_seq
    (2, 8, 2, 64, 128, 4),    # tests/test_kernels.py
    (3, 4, 4, 128, 128, 2),
    (1, 8, 1, 64, 256, 3),
    (8, 8, 4, 32, 16, 4),     # demo engine: G=2
    (4, 16, 2, 32, 16, 3),    # narrow G=8
    (16, 32, 4, 64, 16, 16),  # TinyLlama-1.1B, max_len 256
    (2, 32, 2, 128, 7, 5),    # G=16, odd page size
    (2, 4, 4, 80, 16, 5),     # zamba2's shared attention head dim, G=1
    (3, 16, 4, 160, 64, 3),   # stablelm-12b's head dim, G=4
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


SPLIT = t_kernel.SPLIT_TOKENS
# kv_len at page edges (16-token pages) and at split edges
EDGE_KV = [0, 15, 16, 17, SPLIT - 1, SPLIT, SPLIT + 1]


def _decode_inputs(kv_len, Hq, KVH, hd, page, dtype, dev, seed=11, extra=1):
    """A decode step's inputs: tables ``extra`` pages wider than the longest
    row needs, trash page 0 past the page each row's new slot lies in."""
    rng = np.random.RandomState(seed)
    B = len(kv_len)
    nps = max(kv_len) // page + 1 + extra
    P = B * nps + 2

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    q, k, v = arr(B, Hq, hd), arr(P, page, KVH, hd), arr(P, page, KVH, hd)
    k_new, v_new = arr(B, KVH, hd), arr(B, KVH, hd)
    tables = (rng.permutation(B * nps) + 2).reshape(B, nps).astype(np.int32)
    for b, n in enumerate(kv_len):
        tables[b, n // page + 1:] = 0
    return (q, k_new, v_new, k, v, torch.from_numpy(tables).to(dev),
            torch.tensor(kv_len, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 160])
def test_paged_decode_fused_matches_scatter_then_ref(card, hd, G, dtype):
    """One fused launch against write_token_to_pages + the plain version:
    the pages bitwise, the output at the kernel tolerances (bf16 also
    within one bf16 ulp), kv_len at page and split edges."""
    KVH = 2
    q, kn, vn, k, v, tables, kv_len = _decode_inputs(
        EDGE_KV, G * KVH, KVH, hd, 16, getattr(torch, dtype), card)
    want_k, want_v = write_token_to_pages(k.clone(), v.clone(), tables,
                                          kv_len, kn, vn)
    want = paged_attention_ref(q, want_k, want_v, tables, kv_len + 1)
    before = t_kernel.launches
    o, k2, v2 = paged_decode_step(q, kn, vn, k, v, tables, kv_len)
    torch.cuda.synchronize()
    assert t_kernel.launches == before + 1
    assert k2 is k and v2 is v
    assert torch.equal(k, want_k) and torch.equal(v, want_v)
    torch.testing.assert_close(o.float(), want.float(), **TOL[dtype])
    if dtype == "bfloat16":
        # P is kept as a bf16 hi/lo pair (to ~2^-17) and the output rounded
        # once, like the fp32 plain version's: within one bf16 ulp of it
        assert bf16_ulp_err(o, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split_tokens", [64, 256, 512])
def test_paged_decode_other_split_lengths(card, split_tokens, dtype):
    """The split lengths the sweep times agree with the plain version."""
    kv = [0, 63, 64, 300, 511, 512, 1000]
    q, kn, vn, k, v, tables, kv_len = _decode_inputs(
        kv, 32, 4, 64, 16, getattr(torch, dtype), card)
    want_k, want_v = write_token_to_pages(k.clone(), v.clone(), tables,
                                          kv_len, kn, vn)
    want = paged_attention_ref(q, want_k, want_v, tables, kv_len + 1)
    o = t_kernel.paged_decode_cuda(q, kn, vn, k, v, tables, kv_len,
                                   split_tokens=split_tokens)
    torch.cuda.synchronize()
    assert torch.equal(k, want_k) and torch.equal(v, want_v)
    torch.testing.assert_close(o.float(), want.float(), **TOL[dtype])
    got = t_kernel.paged_attention_cuda(q, k, v, tables, kv_len + 1,
                                        split_tokens=split_tokens)
    assert torch.equal(got, o)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", [0, 17, SPLIT - 1, SPLIT, 3 * SPLIT + 5])
def test_paged_decode_row_bits_independent_of_batch_and_width(card, kv,
                                                              dtype):
    """A row computed alone (table as wide as it needs), inside a batch of
    16 other rows, and with a table twice as wide: bitwise one output."""
    lens = [int(x) for x in np.random.RandomState(kv).randint(0, 4 * SPLIT,
                                                              16)]
    lens[5] = kv
    q, kn, vn, k, v, tables, kv_len = _decode_inputs(
        lens, 32, 4, 64, 16, getattr(torch, dtype), card, seed=kv)
    batch = paged_decode_step(q, kn, vn, k, v, tables, kv_len)[0]
    row = slice(5, 6)
    need = kv // 16 + 1
    alone = paged_decode_step(q[row], kn[row], vn[row], k, v,
                              tables[row, :need].contiguous(),
                              kv_len[row])[0]
    wide_t = torch.zeros(1, 2 * tables.shape[1], dtype=torch.int32,
                         device=card)
    wide_t[:, :need] = tables[row, :need]
    wide = paged_decode_step(q[row], kn[row], vn[row], k, v, wide_t,
                             kv_len[row])[0]
    torch.cuda.synchronize()
    assert torch.equal(alone[0], batch[5])
    assert torch.equal(wide[0], batch[5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attend_only_matches_fused_bitwise(card, dtype):
    """The attend-only launch over the pages the fused one wrote gives the
    fused output bit for bit, and a second fused call (the same row
    written again) changes nothing."""
    q, kn, vn, k, v, tables, kv_len = _decode_inputs(
        EDGE_KV + [3 * SPLIT + 1], 16, 2, 64, 16, getattr(torch, dtype),
        card)
    fused = paged_decode_step(q, kn, vn, k, v, tables, kv_len)[0]
    pages = k.clone(), v.clone()
    attend = paged_attention(q, k, v, tables, kv_len + 1)
    again = paged_decode_step(q, kn, vn, k, v, tables, kv_len)[0]
    torch.cuda.synchronize()
    assert torch.equal(attend, fused) and torch.equal(again, fused)
    assert torch.equal(k, pages[0]) and torch.equal(v, pages[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_lookahead_writes_reach_the_last_slot(card, dtype):
    """Speculation's draft and verify walks write at kv_len .. kv_len + 3
    (lookahead 4), up to the last slot a row's own pages hold: the engine
    sizes each slot with that much headroom.  Four consecutive fused steps
    ending on each row's last slot, across page and split edges, in a
    table padded with the trash page to the widest row: after every step
    both slabs are bitwise what ``write_token_to_pages`` makes, so no byte
    outside the written slot changes (the trash page and pages no table
    references included), and the outputs agree with the plain version."""
    page, ahead = 16, 4
    own = [2, SPLIT // page, SPLIT // page + 1, 2 * SPLIT // page + 1,
           3 * SPLIT // page]  # last slots 31, 127, 143, 271, 383
    B, nps, KVH, Hq, hd = len(own), max(own), 4, 32, 64
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(3)
    P = 1 + sum(own) + 3  # the trash page, the rows' pages, three spare

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(card, dt)

    k, v = arr(P, page, KVH, hd), arr(P, page, KVH, hd)
    pages = rng.permutation(sum(own)) + 1
    tables = np.zeros((B, nps), np.int32)
    at = 0
    for b, n in enumerate(own):
        tables[b, :n] = pages[at:at + n]
        at += n
    tables = torch.from_numpy(tables).to(card)
    kv0 = torch.tensor([n * page - ahead for n in own], dtype=torch.int32,
                       device=card)
    for j in range(ahead):
        q, kn, vn = arr(B, Hq, hd), arr(B, KVH, hd), arr(B, KVH, hd)
        kv_len = kv0 + j
        want_k, want_v = write_token_to_pages(k.clone(), v.clone(), tables,
                                              kv_len, kn, vn)
        want = paged_attention_ref(q, want_k, want_v, tables, kv_len + 1)
        o = paged_decode_step(q, kn, vn, k, v, tables, kv_len)[0]
        torch.cuda.synchronize()
        assert torch.equal(k, want_k) and torch.equal(v, want_v), j
        torch.testing.assert_close(o.float(), want.float(), **TOL[dtype])
        if dtype == "bfloat16":
            assert bf16_ulp_err(o, want) <= 1.0
    assert (kv0 + ahead).tolist() == [n * page for n in own]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_row_without_keys_is_zero(card, dtype):
    """Attend only, a row of length 0 beside rows with several splits: its
    output is 0 (no live split), as the Pallas kernel's; the other rows
    match the plain version."""
    q, k, v, tables, lens = _inputs(4, 8, 2, 64, 16, 20, getattr(torch, dtype),
                                    card)
    lens[1] = 0
    tables[1] = 0
    got = paged_attention(q, k, v, tables, lens)
    want = paged_attention_ref(q, k, v, tables, lens)
    torch.cuda.synchronize()
    assert not got[1].float().abs().max()
    keep = [0, 2, 3]
    torch.testing.assert_close(got[keep].float(), want[keep].float(),
                               **TOL[dtype])


@pytest.mark.cuda
def test_paged_decode_rejects_bad_inputs(card):
    q, kn, vn, k, v, tables, kv_len = _decode_inputs(
        [3, 20], 8, 4, 32, 16, torch.bfloat16, card)
    with pytest.raises(TypeError):
        paged_decode_step(q, kn.float(), vn.float(), k, v, tables, kv_len)
    with pytest.raises(ValueError):
        paged_decode_step(q, kn[:, :2].contiguous(), vn, k, v, tables,
                          kv_len)
    with pytest.raises(TypeError):
        paged_decode_step(q, kn, vn, k, v, tables, kv_len.float())


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

FLASH_SHAPES = [  # B, Hq, KVH, S, hd
    (2, 8, 2, 256, 64),    # tests/test_kernels.py: GQA
    (1, 4, 4, 128, 32),    # MHA
    (1, 4, 1, 512, 128),   # MQA
    (2, 8, 4, 100, 32),    # demo heads, ragged S
    (2, 32, 4, 129, 64),   # TinyLlama heads, one past a tile
    (3, 32, 4, 1, 64),     # a single position
    (1, 32, 4, 17, 64),
    (2, 32, 32, 129, 80),  # zamba2's shared attention: G = 1, hd 80
    (2, 32, 8, 100, 160),  # stablelm-12b: G = 4, hd 160
]


def _flash_inputs(B, Hq, KVH, S, hd, dtype, dev, seed=0):
    """Seeded (B, S, H, hd) tensors seen as (B, H, S, hd) views, the layout
    the serving path hands the kernel."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, hd))
                                .astype(np.float32)).to(dev, dtype)
               .transpose(1, 2) for h in (Hq, KVH, KVH))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernel_matches_ref(card, shape, dtype, causal):
    q, k, v = _flash_inputs(*shape, getattr(torch, dtype), card)
    before = flash_kernel.launches
    got = flash_attention(q, k, v, causal=causal)  # auto: CUDA -> kernel
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert got.stride() == q.stride()  # the output follows q's layout
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    contiguous = flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal, impl="cuda")
    torch.testing.assert_close(contiguous, got, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_prefix_is_bitwise(card, dtype):
    """A causal prefix computed alone equals the same rows of a longer
    call bit for bit: the recompute-on-readmit prefill relies on it."""
    q, k, v = _flash_inputs(2, 32, 4, 300, 64, getattr(torch, dtype), card)
    full = flash_attention(q, k, v, impl="cuda")
    for n in (1, 63, 65, 200):
        part = flash_attention(q[:, :, :n], k[:, :, :n], v[:, :, :n],
                               impl="cuda")
        torch.testing.assert_close(part, full[:, :, :n], rtol=0, atol=0)


FLASH_EDGE_S = [1, 15, 63, 65, 1468, 2048]  # around the 64-key tiles


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 160])
@pytest.mark.parametrize("S", FLASH_EDGE_S)
def test_flash_attention_kernel_tile_edges(card, S, hd, G, dtype):
    """Every head dim and group size at lengths on both sides of the
    64-key tiles and at the long path's lengths: the bf16 tensor-core
    body and the fp32 one against the plain version."""
    q, k, v = _flash_inputs(1, 8, 8 // G, S, hd, getattr(torch, dtype), card,
                            seed=S + hd + G)
    got = flash_attention(q, k, v, impl="cuda")
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 160])
def test_flash_attention_kernel_prefix_is_bitwise_per_shape(card, hd, G,
                                                            dtype):
    """The prefix property at every head dim and group size: a causal
    prefix alone equals the same rows of a longer call bit for bit."""
    q, k, v = _flash_inputs(2, 8, 8 // G, 200, hd, getattr(torch, dtype),
                            card, seed=hd + G)
    full = flash_attention(q, k, v, impl="cuda")
    for n in (1, 15, 63, 64, 65, 129):
        part = flash_attention(q[:, :, :n], k[:, :, :n], v[:, :, :n],
                               impl="cuda")
        torch.testing.assert_close(part, full[:, :, :n], rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_bad_inputs(card):
    q, k, v = _flash_inputs(1, 8, 4, 32, 32, torch.float32, card)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), impl="cuda")
    with pytest.raises(ValueError):  # head_dim 16
        flash_attention(q[..., :16], k[..., :16], v[..., :16], impl="cuda")
    with pytest.raises(ValueError):  # the head dim is not contiguous
        flash_attention(q.transpose(2, 3), k.transpose(2, 3),
                        v.transpose(2, 3), impl="cuda")
    with pytest.raises(ValueError):  # KVH does not divide Hq
        flash_attention(q[:, :6], k[:, :4], v[:, :4], impl="cuda")
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v.cpu(), impl="cuda")


# ---------------------------------------------------------------------------
# batched LoRA
# ---------------------------------------------------------------------------

LORA_SHAPES = [  # T, D, F, G, r, bt
    (256, 128, 256, 4, 16, 128),   # tests/test_kernels.py
    (512, 256, 512, 2, 8, 128),
    (128, 64, 128, 1, 4, 128),
    (100, 64, 72, 2, 8, 64),       # T and F off the tiles
    (16, 2048, 256, 1, 8, 128),    # TinyLlama decode, v projection
    (4, 2048, 2048, 1, 8, 128),    # TinyLlama decode, q projection
    (3, 200, 72, 2, 64, 64),       # split path: rank 64, D off the chunk
    (250, 200, 136, 3, 8, 64),     # split path over four adapters' tiles
    (300, 256, 128, 3, 64, 128),   # rank 64
]


def _lora_inputs(T, D, F, G, r, bt, dtype, dev, seed=2):
    rng = np.random.RandomState(seed)

    def arr(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev, dtype)

    x = arr((T, D), 1.0)
    w = arr((D, F), 1 / np.sqrt(D))
    a = arr((G, D, r), 1 / np.sqrt(D))
    b = arr((G, r, F), 1 / np.sqrt(r))
    tiles = torch.from_numpy(rng.randint(0, G, size=-(-T // bt))
                             .astype(np.int32)).to(dev)
    return x, w, a, b, tiles


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LORA_SHAPES)
def test_batched_lora_kernel_matches_ref(card, shape, dtype):
    bt = shape[-1]
    x, w, a, b, tiles = _lora_inputs(*shape, getattr(torch, dtype), card)
    before = lora_kernel.launches
    got = batched_lora(x, w, a, b, tiles, bt=bt, scaling=0.5)  # auto
    torch.cuda.synchronize()
    assert lora_kernel.launches == before + 1
    want = batched_lora_ref(x, w, a, b, tiles, bt=bt, scaling=0.5)
    assert got.dtype == x.dtype and got.shape == (shape[0], shape[2])
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **LORA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_lora_kernel_packed_segments(card, dtype):
    """Rows of four adapters in ragged segments, packed tile-aligned by
    pack_segments: every real row gets its own adapter's delta."""
    T, D, F, G, r, bt = 300, 256, 256, 4, 8, 64
    x, w, a, b, _ = _lora_inputs(T, D, F, G, r, bt, getattr(torch, dtype),
                                 card)
    gid = np.random.RandomState(4).randint(0, G, size=T)
    order, tiles, padded = pack_segments(gid, bt=bt)
    rows = torch.from_numpy(np.maximum(order, 0)).long().to(card)
    xp = x[rows] * torch.from_numpy(order >= 0).to(card, x.dtype)[:, None]
    tiles_t = torch.from_numpy(tiles).to(card)
    got = batched_lora(xp, w, a, b, tiles_t, bt=bt, impl="cuda")
    want = batched_lora_ref(xp, w, a, b, tiles_t, bt=bt)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **LORA_TOL[dtype])
    real = torch.from_numpy(order >= 0).to(card)
    per_row = (x.float() @ w.float() + torch.einsum(
        "td,tdr,trf->tf", x.float(), a[torch.from_numpy(gid).to(card)].float(),
        b[torch.from_numpy(gid).to(card)].float())).to(x.dtype)
    np.testing.assert_allclose(got[real].float().cpu().numpy(),
                               per_row[rows[real]].float().cpu().numpy(),
                               **LORA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [256, 200, 2048])
def test_batched_lora_kernel_rows_are_bitwise_independent(card, D, dtype):
    """A row's bits do not depend on T: decode batches and short prefills
    (the split-D path, T <= 256) and long prefills (the tiled path)
    agree."""
    x, w, a, b, _ = _lora_inputs(300, D, 128, 1, 8, 128,
                                 getattr(torch, dtype), card)
    full = batched_lora(x, w, a, b, torch.zeros(3, dtype=torch.int32,
                                                 device=card), impl="cuda")
    for n in (1, 3, 16, 17, 65, 256, 257):
        part = batched_lora(x[:n], w, a, b, torch.zeros(
            -(-n // 128), dtype=torch.int32, device=card), impl="cuda")
        torch.testing.assert_close(part, full[:n], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [72, 256, 2048])
@pytest.mark.parametrize("D", [200, 2048])
@pytest.mark.parametrize("T", [1, 15, 17, 255, 257, 1000, 4096])
def test_batched_lora_kernel_tile_edges(card, T, D, F, dtype):
    """Four adapters, one per 128-row tile, at T on both sides of the
    16-row groups, the split threshold's neighbourhood and long prefills;
    D and F off the 128-wide tiles.  Both paths are run at every T (the
    wrapper's choice and the forced other one): each matches the plain
    version and the two agree bit for bit."""
    x, w, a, b, tiles = _lora_inputs(T, D, F, 4, 8, 128,
                                     getattr(torch, dtype), card, seed=T + F)
    want = batched_lora_ref(x, w, a, b, tiles, scaling=0.5)
    auto = lora_kernel.batched_lora_cuda(x, w, a, b, tiles, scaling=0.5)
    other = lora_kernel.batched_lora_cuda(x, w, a, b, tiles, scaling=0.5,
                                          split=T > lora_kernel.SPLIT_T)
    torch.cuda.synchronize()
    np.testing.assert_allclose(auto.float().cpu().numpy(),
                               want.float().cpu().numpy(), **LORA_TOL[dtype])
    torch.testing.assert_close(other, auto, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [256, 200, 2048])
def test_batched_lora_kernel_rows_bitwise_across_split_threshold(card, D,
                                                                 dtype):
    """T = SPLIT_T runs the split path and SPLIT_T + 1 the tiled one, at
    the serving path's q width: their rows equal a longer call's bit for
    bit."""
    n = lora_kernel.SPLIT_T
    x, w, a, b, _ = _lora_inputs(n + 300, D, 2048, 1, 8, 128,
                                 getattr(torch, dtype), card)

    def run(rows):
        return batched_lora(x[:rows], w, a, b, torch.zeros(
            -(-rows // 128), dtype=torch.int32, device=card), impl="cuda")

    full = run(n + 300)
    for rows in (n, n + 1):
        torch.testing.assert_close(run(rows), full[:rows], rtol=0, atol=0)


@pytest.mark.cuda
def test_batched_lora_kernel_rejects_bad_inputs(card):
    x, w, a, b, tiles = _lora_inputs(64, 64, 64, 1, 4, 64, torch.float32,
                                     card)
    with pytest.raises(TypeError):
        batched_lora(x.half(), w.half(), a.half(), b.half(), tiles, bt=64,
                     impl="cuda")
    with pytest.raises(ValueError):  # bt not a multiple of 64
        batched_lora(x, w, a, b, torch.zeros(2, dtype=torch.int32,
                                             device=card), bt=32, impl="cuda")
    with pytest.raises(ValueError):  # tile ids of the wrong length
        batched_lora(x, w, a, b, torch.zeros(3, dtype=torch.int32,
                                             device=card), bt=64, impl="cuda")
    with pytest.raises(ValueError):  # W not contiguous
        batched_lora(x, w.t(), a, b, tiles, bt=64, impl="cuda")
    with pytest.raises(ValueError):  # rank above 64
        batched_lora(x, w, torch.zeros(1, 64, 65, device=card),
                     torch.zeros(1, 65, 64, device=card), tiles, bt=64,
                     impl="cuda")


# ---------------------------------------------------------------------------
# the dense Model API's kernel routes: one page of S tokens per sequence
# ---------------------------------------------------------------------------

# TinyLlama; qwen2-72b; zamba2's shared attention (G = 1); stablelm-12b
ONE_PAGE_HEADS = [(32, 4, 64), (64, 8, 128), (32, 32, 80), (32, 8, 160)]


def _one_page_inputs(B, Hq, KVH, hd, S, dtype, dev, seed=11):
    """A stacked cache layer (B, S, KVH, hd) seen as B pages of S tokens,
    the table arange(B), kv_len ragged up to S - 1."""
    rng = np.random.RandomState(seed)
    q, kn, vn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(dev, dtype) for s in ((B, Hq, hd), (B, KVH, hd),
                                           (B, KVH, hd)))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, KVH, hd))
                             .astype(np.float32)).to(dev, dtype)
            for _ in range(2))
    tables = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    kv_len = torch.tensor([0, 63, S // 2 + 1, S - 1][:B], dtype=torch.int32,
                          device=dev)
    return q, kn, vn, k, v, tables, kv_len


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", ONE_PAGE_HEADS)
@pytest.mark.parametrize("S", [600, 576])
def test_paged_decode_one_page_per_sequence(card, S, heads, dtype):
    """Page = S (576 = the model_api phase's max_len, 600 off every tile
    and split edge): the fused step against write_token_to_pages + the
    plain version, pages bitwise."""
    q, kn, vn, k, v, tables, kv_len = _one_page_inputs(
        4, *heads, S, getattr(torch, dtype), card)
    want_k, want_v = write_token_to_pages(k.clone(), v.clone(), tables,
                                          kv_len, kn, vn)
    want = paged_attention_ref(q, want_k, want_v, tables, kv_len + 1)
    o, _, _ = paged_decode_step(q, kn, vn, k, v, tables, kv_len, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(k, want_k) and torch.equal(v, want_v)
    torch.testing.assert_close(o.float(), want.float(), **TOL[dtype])
    if dtype == "bfloat16":
        assert bf16_ulp_err(o, want) <= 1.0


def _small_dense_cfg():
    """A 2-layer dense config with the kernels' head dim (64)."""
    from repro_torch.configs import get_reduced_config

    return get_reduced_config("tinyllama-1.1b").replace(
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_decode_drops_the_write_at_kv_len_S(card, dtype):
    """The Model API's decode at kv_len = S - 1, then S: the kernel route
    (the fused step, then the masked write + the attend-only launch over S
    positions) against the kernels' plain versions (``ref``): logits at
    the kernel tolerance, layer 0's cache (no attention upstream) bitwise,
    the whole cache at the tolerance in fp32, and the write at S dropped."""
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model

    cfg = _small_dense_cfg()
    model = build_model(cfg, compute_dtype=getattr(torch, dtype))
    params = model.init(torch.Generator(card).manual_seed(0))
    g = torch.Generator(card).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 10), generator=g,
                           device=card, dtype=torch.int32)
    caches = {impl: model.prefill(params, {"tokens": tokens}, max_len=12,
                                  attn_impl=impl)[1]
              for impl in ("cuda", "ref")}
    for kv in ((11, 9), (12, 10)):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 1),
                                         generator=g, device=card,
                                         dtype=torch.int32),
                 "kv_len": torch.tensor(kv, dtype=torch.int32, device=card)}
        row0 = caches["cuda"]["k"][:, 0].clone()
        before = t_kernel.launches
        got, _ = model.decode_step(params, caches["cuda"], batch,
                                   attn_impl="cuda")
        want, _ = model.decode_step(params, caches["ref"], batch,
                                    attn_impl="ref")
        torch.cuda.synchronize()
        assert t_kernel.launches == before + cfg.num_layers
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        if kv[0] >= 12:  # row 0's write at S was dropped
            assert torch.equal(caches["cuda"]["k"][:, 0], row0)
        for name in ("k", "v"):
            assert torch.equal(caches["cuda"][name][0],
                               caches["ref"][name][0])
            if dtype == "float32":
                torch.testing.assert_close(caches["cuda"][name],
                                           caches["ref"][name], **TOL[dtype])
    assert T.decode_route(cfg, got, "auto") == "paged"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 40, 40, 256, 128),   # qwen1.5-32b, G=1
                                   (4, 64, 8, 128, 128)])   # qwen2-72b, G=8
def test_flash_attention_hd128_main_path_shapes(card, shape, dtype):
    q, k, v = _flash_inputs(*shape, getattr(torch, dtype), card)
    got = flash_attention(q, k, v, causal=True, impl="cuda")
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# ---------------------------------------------------------------------------
# the MoE and encoder-decoder Model API's kernel routes
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", [
    ((4, 48, 8, 256, 128), True),   # dbrx-132b prefill: G = 6
    ((4, 48, 8, 512, 128), True),   # mixtral-8x22b prefill
    ((4, 16, 16, 256, 64), False),  # seamless-m4t encoder, non-causal
    ((4, 16, 16, 64, 64), True)])   # seamless-m4t decoder prefill
def test_flash_attention_moe_and_encdec_shapes(card, shape, causal, dtype):
    q, k, v = _flash_inputs(*shape, getattr(torch, dtype), card)
    got = flash_attention(q, k, v, causal=causal, impl="cuda")
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(16, 16, 64), (48, 8, 128),
                                   (32, 32, 80), (32, 8, 160)])
def test_paged_attend_only_over_a_cross_cache(card, heads, dtype):
    """The encoder-decoder's cross-attention at decode: a layer's xk/xv
    (B, 256, H, hd) as B pages of 256 frames, lengths below the page for
    two rows; the attend-only kernel writes nothing."""
    Hq, KVH, hd = heads
    _, _, _, k, v, tables, _ = _one_page_inputs(4, Hq, KVH, hd, 256,
                                                getattr(torch, dtype), card)
    q = torch.randn(4, Hq, hd, device=card).to(getattr(torch, dtype))
    lens = torch.tensor([256, 256, 200, 137], dtype=torch.int32, device=card)
    k0, v0 = k.clone(), v.clone()
    got = paged_attention(q, k, v, tables, lens, impl="cuda")
    torch.cuda.synchronize()
    want = paged_attention_ref(q, k, v, tables, lens)
    assert torch.equal(k, k0) and torch.equal(v, v0)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if dtype == "bfloat16":
        assert bf16_ulp_err(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_prefill_past_the_window_on_flash(card, dtype):
    """A sliding-window config's prefill inside its window (32 tokens) and
    past it (69 tokens in 32) runs the flash kernel with the window, once a
    layer (counted), against its plain version; that plain version equals
    the windowed reference past the window too (fp32)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model

    cfg = get_reduced_config("mixtral-8x22b").replace(
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=256, sliding_window=32)
    model = build_model(cfg, compute_dtype=getattr(torch, dtype))
    params = model.init(torch.Generator(card).manual_seed(0))
    for S in (32, 69):
        tokens = torch.randint(0, cfg.vocab_size, (2, S), device=card,
                               dtype=torch.int32)
        before = flash_kernel.launches
        got = model.prefill(params, {"tokens": tokens}, attn_impl="cuda")[0]
        want = model.prefill(params, {"tokens": tokens}, attn_impl="ref")[0]
        torch.cuda.synchronize()
        assert flash_kernel.launches == before + cfg.num_layers
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        q, k, v = (x.transpose(1, 2) for x in _flash_inputs(
            2, 4, 2, S, 64, torch.float32, card))
        torch.testing.assert_close(
            T.prefill_attention(q, k, v, cfg, "ref"),
            L.causal_attention(q, k, v, chunk=cfg.attn_chunk, window=32),
            **TOL["float32"])


# S, W: a window of one tile, windows that start mid-tile (100, 40), and
# the long path's lengths
FLASH_WINDOWS = [(300, 64), (300, 100), (129, 40), (2048, 700)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 6])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("S,W", FLASH_WINDOWS)
def test_flash_attention_kernel_window_matches_ref(card, S, W, hd, G, dtype):
    """The kernel with a sliding window past it against the windowed plain
    version: the tolerances and, in bf16, two bf16 ulps (P kept as a bf16
    pair, one rounding); one launch a call; a window of S or more is
    bitwise no window."""
    q, k, v = _flash_inputs(1, 2 * G, 2, S, hd, getattr(torch, dtype), card,
                            seed=S + W + hd + G)
    before = flash_kernel.launches
    got = flash_attention(q, k, v, window=W)  # auto: CUDA -> kernel
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    want = flash_attention_ref(q, k, v, window=W)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if dtype == "bfloat16":
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -6, atol=1e-5)
    torch.testing.assert_close(flash_attention(q, k, v, window=S),
                               flash_attention(q, k, v), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
def test_flash_attention_kernel_window_prefix_is_bitwise(card, G, dtype):
    """The prefix property under a window that starts mid-tile (100): a
    prefix alone equals the same rows of a longer call bit for bit, and
    the wrapper refuses a negative window and a window without causal
    before any launch."""
    q, k, v = _flash_inputs(2, 4 * G, 4, 300, 64, getattr(torch, dtype), card)
    full = flash_attention(q, k, v, window=100, impl="cuda")
    for n in (1, 63, 65, 101, 164, 200, 299):
        part = flash_attention(q[:, :, :n], k[:, :, :n], v[:, :, :n],
                               window=100, impl="cuda")
        torch.testing.assert_close(part, full[:, :, :n], rtol=0, atol=0)
    before = flash_kernel.launches
    for kw in ({"window": -1}, {"window": 100, "causal": False}):
        with pytest.raises(ValueError, match="window"):
            flash_attention(q, k, v, impl="cuda", **kw)
    assert flash_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_decode_runs_the_ring_on_paged(card, dtype):
    """A sliding-window config's decode on the kernel route: the fused
    step while every row is inside its ring of S = 8 slots, then the
    ring's insert and the attend-only launch once a row has reached S (its
    write wrapping to slot kv_len % S), one launch per layer a step,
    against the kernels' plain versions; layer 0's cache bitwise."""
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model

    cfg = _small_dense_cfg().replace(sliding_window=8)
    model = build_model(cfg, compute_dtype=getattr(torch, dtype))
    params = model.init(torch.Generator(card).manual_seed(0))
    g = torch.Generator(card).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=g,
                           device=card, dtype=torch.int32)
    lens = torch.tensor([6, 4], dtype=torch.int32, device=card)
    caches = {impl: model.prefill(params, {"tokens": tokens,
                                           "prompt_lens": lens},
                                  max_len=16, attn_impl=impl)[1]
              for impl in ("cuda", "ref")}
    assert caches["cuda"]["k"].shape[2] == 8
    for j in range(6):  # row 0 reaches S at the third step
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 1),
                                         generator=g, device=card,
                                         dtype=torch.int32),
                 "kv_len": lens + j}
        before = t_kernel.launches
        got, _ = model.decode_step(params, caches["cuda"], batch,
                                   attn_impl="cuda")
        want, _ = model.decode_step(params, caches["ref"], batch,
                                    attn_impl="ref")
        torch.cuda.synchronize()
        assert t_kernel.launches == before + cfg.num_layers
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        for name in ("k", "v"):
            assert torch.equal(caches["cuda"][name][0],
                               caches["ref"][name][0])
    assert T.decode_route(cfg, got, "auto") == "paged"


# ---------------------------------------------------------------------------
# head dims 80 (zamba2's shared attention) and 160 (stablelm-12b)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", [
    ((4, 32, 32, 512, 80), True),    # zamba2 prefill: G = 1
    ((1, 32, 32, 4080, 80), True),   # zamba2's ring run
    ((2, 32, 32, 300, 80), False),
    ((4, 32, 8, 256, 160), True),    # stablelm-12b prefill: G = 4
    ((2, 32, 8, 300, 160), False)])
def test_flash_attention_hd80_hd160_shapes(card, shape, causal, dtype):
    q, k, v = _flash_inputs(*shape, getattr(torch, dtype), card)
    got = flash_attention(q, k, v, causal=causal, impl="cuda")
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(32, 32, 80), (32, 8, 160)])
def test_paged_attend_only_over_a_full_ring(card, heads, dtype):
    """A sliding window's ring of 4,096 slots once a row has reached it
    (zamba2's decode past its window): the attend-only launch over all
    4,096 slots and over fewer, against the plain version; the fused step
    at the ring's last slot too."""
    Hq, KVH, hd = heads
    q, kn, vn, k, v, tables, _ = _one_page_inputs(
        2, Hq, KVH, hd, 4096, getattr(torch, dtype), card)
    lens = torch.tensor([4096, 3000], dtype=torch.int32, device=card)
    got = paged_attention(q, k, v, tables, lens, impl="cuda")
    torch.cuda.synchronize()
    want = paged_attention_ref(q, k, v, tables, lens)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    kv_len = lens - 1
    want_k, want_v = write_token_to_pages(k.clone(), v.clone(), tables,
                                          kv_len, kn, vn)
    want = paged_attention_ref(q, want_k, want_v, tables, lens)
    o, _, _ = paged_decode_step(q, kn, vn, k, v, tables, kv_len, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(k, want_k) and torch.equal(v, want_v)
    torch.testing.assert_close(o.float(), want.float(), **TOL[dtype])
    if dtype == "bfloat16":
        assert bf16_ulp_err(o, want) <= 1.0


def _chain_close(got, want, dtype):
    """A whole chain's logits: fp32 at the kernel tolerance; bf16, where a
    chain of six hops drifts by a bf16 ulp or two a hop, within three
    times the per-hop bound (2e-2 + 2e-2 |x| + one bf16 ulp at the row's
    largest logit), as chip_smoke.py holds whole bf16 chains."""
    got, want = got.float(), want.float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, **TOL[dtype])
        return
    mag = want.abs().amax(dim=-1, keepdim=True)
    _, e = torch.frexp(mag)
    bound = 2e-2 + 2e-2 * want.abs() + torch.ldexp(torch.ones_like(mag),
                                                   e - 8)
    assert float(((got - want).abs() / bound).max()) <= 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_decode_crosses_the_ring_on_paged(card, dtype):
    """zamba2's reduced config widened to head dim 80 (d_model 320, 4/4
    heads: G = 1): prefill of 28 tokens on flash (one launch per shared
    block application), then 8 decode steps across the ring of 32 (the
    fused step, then the ring's insert and the attend-only launch, one
    launch per application a step), against the kernels' plain versions
    (``_chain_close``)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model

    cfg = get_reduced_config("zamba2-2.7b").replace(
        d_model=320, num_heads=4, num_kv_heads=4, d_ff=256)
    assert cfg.resolved_head_dim == 80
    n_super = cfg.num_layers // cfg.shared_attn_every
    model = build_model(cfg, compute_dtype=getattr(torch, dtype))
    params = model.init(torch.Generator(card).manual_seed(0))
    g = torch.Generator(card).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 28), generator=g,
                           device=card, dtype=torch.int32)
    lens = torch.tensor([28, 24], dtype=torch.int32, device=card)
    before = flash_kernel.launches
    out = {impl: model.prefill(params, {"tokens": tokens,
                                        "prompt_lens": lens},
                               max_len=48, attn_impl=impl)
           for impl in ("cuda", "ref")}
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + n_super
    _chain_close(out["cuda"][0], out["ref"][0], dtype)
    caches = {impl: out[impl][1] for impl in out}
    assert caches["cuda"]["attn"]["k"].shape[2] == 32
    for j in range(8):  # row 0 reaches the ring's end at the fifth step
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 1),
                                         generator=g, device=card,
                                         dtype=torch.int32),
                 "kv_len": lens + j}
        before = t_kernel.launches
        got, _ = model.decode_step(params, caches["cuda"], batch,
                                   attn_impl="cuda")
        want, _ = model.decode_step(params, caches["ref"], batch,
                                    attn_impl="ref")
        torch.cuda.synchronize()
        assert t_kernel.launches == before + n_super
        _chain_close(got, want, dtype)
    assert T.decode_route(cfg, got, "auto") == "paged"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "mixtral-8x22b",
                                  "seamless-m4t-medium", "zamba2-2.7b",
                                  "xlstm-125m"])
def test_train_step_on_the_card_matches_the_cpu(card, name):
    """One fp32 train step of a reduced config on the card against the
    same step on the CPU: the loss within 1e-5 (relative), every
    gradient within 1e-4 in relative L2 norm; no kernel launches inside
    the train loss, whose attention is counted on the plain route."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_reduced_config(name)
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(DataConfig(
        cfg.vocab_size, global_batch=2, seq_len=40)).batch_at(0).items()}
    if cfg.family == "encdec":
        batch["frames"] = 0.1 * torch.randn(
            2, 24, cfg.d_model, generator=torch.Generator().manual_seed(1))
    want_loss, want = value_and_grad(model, params, batch)
    for m in (t_kernel, flash_kernel, lora_kernel):
        m.launches = 0
    for k in T.PREFILL_ROUTES:
        T.PREFILL_ROUTES[k] = 0
    loss, grads = value_and_grad(model, tree_map(lambda t: t.to(card),
                                                 params),
                                 {k: v.to(card) for k, v in batch.items()})
    assert (t_kernel.launches, flash_kernel.launches,
            lora_kernel.launches) == (0, 0, 0)
    assert T.PREFILL_ROUTES["flash"] == T.PREFILL_ROUTES["flash_ref"] == 0
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        err = float((g.cpu() - w).norm()) / max(float(w.norm()), 1e-30)
        assert err <= 1e-4, err


# ---------------------------------------------------------------------------
# megastep graphs: the fused decode megastep captured and replayed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_zoo():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.serving.demo import build_demo_zoo

    return build_demo_zoo(0, device="cuda")[2]


def _graph_sides(zoo, n, app="app-lora"):
    """Two executors over KV pools prefilled alike on the card: one that
    captures and replays its megastep graphs, one that runs the same
    padded megastep over the same buffers eagerly on every call."""
    from test_torch_megastep_graph import MAX_LEN, _Side

    graph = _Side(zoo, app, "bfloat16", n, MAX_LEN, device="cuda")
    eager = _Side(zoo, app, "bfloat16", n, MAX_LEN, device="cuda")

    def first_call(g, fn, pk, pv):
        eager.ex._run_static(g, fn, pk, pv)
        g.ready = True

    eager.ex._capture = first_call
    return graph, eager


def _same_on_the_card(graph, eager, groups):
    torch.cuda.synchronize()
    for g in groups:
        a = graph.ex.decode_states[tuple(g)]
        b = eager.ex.decode_states[tuple(g)]
        for name in ("next_token", "kv_len", "probs"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in zip(graph.slabs(), eager.slabs()):
        assert torch.equal(x, y)  # the trash page too: pads ran alike


@pytest.mark.cuda
def test_megastep_replay_matches_the_eager_bucket(demo_zoo):
    """Replays of the captured megastep equal the same padded megastep
    issued eagerly, bitwise in tokens, probabilities, kv lengths and every
    page, over steps that re-stage a bucket (a finish, a join) and open a
    second one; retiring gives the same host states.  The kernel modules'
    launch counters advance alike on both sides: a replay adds the
    launches its graph recorded, and a capture counts only its eager run."""
    from test_torch_megastep_graph import SCHEDULE, _assert_same_host

    def launched(side, g):
        before = (t_kernel.launches, lora_kernel.launches)
        side.step([g])
        return (t_kernel.launches - before[0],
                lora_kernel.launches - before[1])

    graph, eager = _graph_sides(demo_zoo, 12)
    for g in SCHEDULE:
        got = launched(graph, g)
        want = launched(eager, g)
        assert got == want and min(want) > 0, (got, want)
        _same_on_the_card(graph, eager, [g])
        assert graph.ex.decode_states[tuple(g)].graph.graph is not None
        assert eager.ex.decode_states[tuple(g)].graph.graph is None
    graph.ex.retire_states()
    eager.ex.retire_states()
    _assert_same_host(graph, eager)
    c = graph.counters()
    assert (c["graph_captures"], c["graph_replays"]) == (2, len(SCHEDULE) - 2)


@pytest.mark.cuda
def test_megastep_replay_survives_a_larger_paged_call(demo_zoo, card):
    """A paged call wide enough to replace the kernel's counter buffer
    leaves the captured graphs right: each keeps the buffer it points
    into."""
    graph, eager = _graph_sides(demo_zoo, 6, app="base")
    g = [0, 1, 2, 3, 4, 5]
    for side in (graph, eager):
        side.step([g])
    buf = graph.ex.decode_states[tuple(g)].graph
    dev = buf.ints.device
    old = t_kernel._counters[dev]
    assert buf.keep[0] is old
    KVH = 4
    q, kp, vp, tables, lens = _inputs(old.numel() // KVH + 1, 8, KVH, 32, 16,
                                      2, torch.bfloat16, card)
    paged_attention(q, kp, vp, tables, lens)
    assert t_kernel._counters[dev] is not old
    for _ in range(4):
        for side in (graph, eager):
            side.step([g])
        _same_on_the_card(graph, eager, [g])
    assert graph.counters()["graph_replays"] == 4


@pytest.mark.cuda
def test_steady_megastep_replay_holds_no_sync(demo_zoo):
    """A bound group's replayed steps issue no host synchronisation."""
    graph, _ = _graph_sides(demo_zoo, 5, app="vicuna")
    g = [0, 1, 2, 3, 4]
    graph.step([g])
    torch.cuda.synchronize()
    states = graph.group(g)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            graph.ex.fused_step(states, graph.kv)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert graph.counters()["graph_replays"] == 3


@pytest.mark.cuda
def test_engine_serves_the_eager_tokens_with_replay(demo_zoo):
    """An engine on the demo zoo serves the same tokens with megastep
    replays as with the eager megastep (its graphs off), through groups
    that finish and join."""
    from test_torch_megastep_graph import _bind_nothing

    from repro_torch.serving.api import ServeRequest
    from repro_torch.serving.engine import BlockEngine, EngineConfig

    rng = np.random.RandomState(3)
    reqs = [ServeRequest(app=("base", "vicuna", "app-lora")[i % 3],
                         gen_len=int(rng.randint(4, 24)),
                         prompt_tokens=rng.randint(0, 512, size=int(
                             rng.randint(6, 60))).astype(np.int32))
            for i in range(24)]
    out = []
    for graphs in (True, False):
        e = BlockEngine(demo_zoo, max_len=128, config=EngineConfig(
            device="cuda", compute_dtype="bfloat16", max_active=16))
        if not graphs:
            e.executor._free_graph = _bind_nothing
        rids = [e.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                      prompt_tokens=r.prompt_tokens))
                for r in reqs[:12]]
        done = {r.rid: r for r in e.step()}
        rids += [e.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                       prompt_tokens=r.prompt_tokens))
                 for r in reqs[12:]]
        done.update({r.rid: r for r in e.drain()})
        out.append(([done[r] for r in rids], dict(e.stats)))
    (got, st), (want, st0) = out
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert st["graph_replays"] > st["graph_captures"] > 0
    assert st0["graph_replays"] == 0
