"""The port's paged decode attention against the JAX reference.

On the CPU the port runs its plain PyTorch version (``ref``); it is held
against JAX's Pallas kernel in interpret mode and against JAX's jnp oracle,
at the shapes of tests/test_kernels.py, at the demo engine's shape
(page 16, hd 32, Hq 8, KVH 4) and at a narrow G=8 case, in fp32 (2e-5) and
bf16 (2e-2).  A plain model of the CUDA kernel's split-KV arithmetic
(per-split partials combined in split order) is held against both at split
edges and with empty trailing splits.  The CUDA kernel itself runs only on
the card: its tests are in tests/test_torch_cuda_kernels.py (no JAX there,
so they run on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import paged_attention as j_kernel
from repro.kernels.paged_attention.ops import (
    paged_decode_step as j_decode_step,
    write_token_to_pages as j_write,
)
from repro.kernels.paged_attention.ref import paged_attention_ref as j_ref
from repro_torch.kernels.paged_attention import kernel as t_kernel
from repro_torch.kernels.paged_attention.ops import (
    paged_attention as t_paged,
    paged_decode_step as t_decode_step,
    write_token_to_pages as t_write,
)
from repro_torch.kernels.paged_attention.ref import paged_attention_split_ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ["float32", "bfloat16"]

SHAPES = [  # B, Hq, KVH, hd, page, pages_per_seq
    (2, 8, 2, 64, 128, 4),   # tests/test_kernels.py
    (3, 4, 4, 128, 128, 2),
    (1, 8, 1, 64, 256, 3),
    (8, 8, 4, 32, 16, 4),    # demo engine: G=2
    (4, 16, 2, 32, 16, 3),   # narrow G=8
]


def make_inputs(B, Hq, KVH, hd, page, nps, seed=0, trash_rows=True):
    """numpy inputs: disjoint shuffled page tables over pages 1.., ragged
    seq_lens including 1, a page edge and a full table, and rows padded
    with trash page 0 past their last page."""
    rng = np.random.RandomState(seed)
    P = B * nps + 2
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((P, page, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, page, KVH, hd)).astype(np.float32)
    tables = (rng.permutation(B * nps) + 2).reshape(B, nps).astype(np.int32)
    lens = rng.randint(1, page * nps + 1, size=B)
    edge = [1, page, page + 1, page * nps]
    lens[:min(B, 4)] = edge[:min(B, 4)]
    if trash_rows:
        for b in range(B):
            tables[b, -(-lens[b] // page):] = 0
    return q, k, v, tables, lens.astype(np.int32)


def _as(dtype, *arrays):
    j = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    t = tuple(torch.from_numpy(a.copy()).to(getattr(torch, dtype))
              for a in arrays)
    return j, t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_jax_kernel_and_oracle(shape, dtype):
    q, k, v, tables, lens = make_inputs(*shape)
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, q, k, v)
    want_kernel = j_kernel(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens),
                           interpret=True)
    want_ref = j_ref(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens))
    got = t_paged(tq, tk, tv, torch.from_numpy(tables),
                  torch.from_numpy(lens))  # auto: CPU tensors -> ref
    assert got.dtype == tq.dtype and got.shape == tq.shape
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_write_token_to_pages_matches_jax(dtype):
    B, Hq, KVH, hd, page, nps = 4, 8, 4, 32, 16, 3
    q, k, v, tables, lens = make_inputs(B, Hq, KVH, hd, page, nps, seed=1)
    rng = np.random.RandomState(2)
    k_new = rng.standard_normal((B, KVH, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, KVH, hd)).astype(np.float32)
    pos = (lens - 1).astype(np.int32)  # lands inside each row's pages
    (jk, jv, jkn, jvn), (tk, tv, tkn, tvn) = _as(dtype, k, v, k_new, v_new)
    wk, wv = j_write(jk, jv, jnp.asarray(tables), jnp.asarray(pos), jkn, jvn)
    gk, gv = t_write(tk, tv, torch.from_numpy(tables), torch.from_numpy(pos),
                     tkn, tvn)
    assert gk is tk and gv is tv  # in place
    np.testing.assert_array_equal(gk.float().numpy(), np.asarray(wk, np.float32))
    np.testing.assert_array_equal(gv.float().numpy(), np.asarray(wv, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_step_matches_jax(dtype):
    """Scatter at kv_len then attend at kv_len + 1, with a padded batch row
    whose table is all trash page 0 (kv_len 0: it writes and reads page 0
    slot 0 only)."""
    B, Hq, KVH, hd, page, nps = 4, 8, 4, 32, 16, 3
    q, k, v, tables, lens = make_inputs(B, Hq, KVH, hd, page, nps, seed=3)
    kv_len = np.minimum(lens, page * nps - 1).astype(np.int32)
    for b in range(B):
        tables[b, -(-(kv_len[b] + 1) // page):] = 0
    tables[-1] = 0
    kv_len[-1] = 0
    rng = np.random.RandomState(4)
    k_new = rng.standard_normal((B, KVH, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, KVH, hd)).astype(np.float32)
    (jq, jk, jv, jkn, jvn), (tq, tk, tv, tkn, tvn) = _as(
        dtype, q, k, v, k_new, v_new)
    wo, wk, wv = j_decode_step(jq, jkn, jvn, jk, jv, jnp.asarray(tables),
                               jnp.asarray(kv_len), impl="ref")
    go, gk, gv = t_decode_step(tq, tkn, tvn, tk, tv, torch.from_numpy(tables),
                               torch.from_numpy(kv_len))
    np.testing.assert_allclose(go.float().numpy(), np.asarray(wo, np.float32),
                               **TOL[dtype])
    np.testing.assert_array_equal(gk.float().numpy(), np.asarray(wk, np.float32))
    np.testing.assert_array_equal(gv.float().numpy(), np.asarray(wv, np.float32))


def test_cuda_impl_on_cpu_tensor_raises():
    q, k, v, tables, lens = make_inputs(2, 8, 4, 32, 16, 2)
    args = [torch.from_numpy(a) for a in (q, k, v, tables, lens)]
    with pytest.raises(ValueError, match="CUDA"):
        t_paged(*args, impl="cuda")
    with pytest.raises(ValueError):
        t_paged(*args, impl="pallas")


def test_kernel_checks_reject_unsupported_inputs():
    """The wrapper's checks raise before any launch (no card needed: the
    device check comes last, so shape and type faults surface here)."""
    q, k, v, tables, lens = (torch.from_numpy(a) for a in
                             make_inputs(2, 8, 4, 32, 16, 2))
    with pytest.raises(ValueError, match="head_dim"):
        t_kernel.check_inputs(q[..., :16], k[..., :16], v[..., :16],
                              tables, lens)
    with pytest.raises(ValueError, match="Hq"):
        t_kernel.check_inputs(torch.zeros(2, 34, 32), torch.zeros(4, 16, 2, 32),
                              torch.zeros(4, 16, 2, 32), tables, lens)
    with pytest.raises(TypeError):
        t_kernel.check_inputs(q.half(), k.half(), v.half(), tables, lens)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.check_inputs(q, k, v, tables, lens)


def _decode_case(kv_len, Hq, KVH, hd, page, nps, seed):
    """numpy inputs of a decode step: disjoint shuffled tables, trash page 0
    past the page that position kv_len opens, new K/V rows."""
    rng = np.random.RandomState(seed)
    B = len(kv_len)
    P = B * nps + 2
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((P, page, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, page, KVH, hd)).astype(np.float32)
    k_new = rng.standard_normal((B, KVH, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, KVH, hd)).astype(np.float32)
    tables = (rng.permutation(B * nps) + 2).reshape(B, nps).astype(np.int32)
    kv_len = np.asarray(kv_len, np.int32)
    for b in range(B):
        tables[b, kv_len[b] // page + 1:] = 0
    return q, k_new, v_new, k, v, tables, kv_len


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_step_page_edges_match_jax(dtype):
    """kv_len at page edges: 15 fills a page's last slot, 16 opens the next
    page (already in the row's table), 0 opens the first."""
    q, kn, vn, k, v, tables, kv_len = _decode_case(
        [0, 15, 16, 17, 31, 32], 8, 4, 32, 16, 4, seed=9)
    (jq, jkn, jvn, jk, jv), (tq, tkn, tvn, tk, tv) = _as(dtype, q, kn, vn,
                                                         k, v)
    wo, wk, wv = j_decode_step(jq, jkn, jvn, jk, jv, jnp.asarray(tables),
                               jnp.asarray(kv_len), impl="ref")
    go, gk, gv = t_decode_step(tq, tkn, tvn, tk, tv, torch.from_numpy(tables),
                               torch.from_numpy(kv_len))
    np.testing.assert_allclose(go.float().numpy(), np.asarray(wo, np.float32),
                               **TOL[dtype])
    np.testing.assert_array_equal(gk.float().numpy(), np.asarray(wk, np.float32))
    np.testing.assert_array_equal(gv.float().numpy(), np.asarray(wv, np.float32))


SPLIT = t_kernel.SPLIT_TOKENS
SPLIT_CASES = [  # split_tokens, seq_lens: at split edges
    (64, [1, 63, 64, 65]),
    (64, [128, 129, 191, 192]),
    (SPLIT, [SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 7]),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("split_tokens,lens", SPLIT_CASES,
                         ids=lambda x: str(x))
def test_split_model_matches_ref_and_jax_kernel(split_tokens, lens, dtype):
    """Per-split partials combined in split order give the one-pass
    answer; every row's table is two splits wider than the longest row
    needs, so each row has empty trailing splits, which take no part."""
    B, Hq, KVH, hd, page = len(lens), 8, 2, 32, 16
    nps = -(-(max(lens) + 2 * split_tokens) // page)
    rng = np.random.RandomState(split_tokens + lens[0])
    P = B * nps + 2
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((P, page, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, page, KVH, hd)).astype(np.float32)
    tables = (rng.permutation(B * nps) + 2).reshape(B, nps).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for b in range(B):
        tables[b, -(-lens[b] // page):] = 0
    assert t_kernel.num_splits(nps, page, split_tokens) \
        >= -(-max(lens) // split_tokens) + 2
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, q, k, v)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    got = paged_attention_split_ref(tq, tk, tv, tt, tl, split_tokens)
    assert torch.isfinite(got.float()).all()
    want_kernel = j_kernel(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens),
                           interpret=True)
    want_ref = t_paged(tq, tk, tv, tt, tl, impl="ref").float().numpy()
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_model_row_without_keys_matches_jax_kernel(dtype):
    """A row of length 0 has no live split: its output is 0, as the
    Pallas kernel's (no page computed, acc / max(l, 1e-30)).  Were its
    empty splits combined, their maximum would be NEG_INF as well and each
    would weigh exp(0) = 1, with l = split_tokens."""
    B, Hq, KVH, hd, page, nps, split = 3, 8, 2, 32, 16, 10, 64
    rng = np.random.RandomState(5)
    P = B * nps + 2
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((P, page, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, page, KVH, hd)).astype(np.float32)
    tables = (rng.permutation(B * nps) + 2).reshape(B, nps).astype(np.int32)
    lens = np.asarray([0, 65, 1], np.int32)
    tables[0] = 0
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, q, k, v)
    got = paged_attention_split_ref(tq, tk, tv, torch.from_numpy(tables),
                                    torch.from_numpy(lens), split)
    want = j_kernel(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens),
                    interpret=True)
    assert not got[0].float().abs().max()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_split_count_follows_table_width_not_batch():
    """The grid's split axis is ceil(width * page / SPLIT_TOKENS) whatever B
    is: the host never reads a length."""
    k = torch.zeros(4, 16, 4, 32)
    for B in (1, 3, 16):
        for n in (1, 8, 9, 16, 256):
            q = torch.zeros(B, 8, 32)
            tables = torch.zeros(B, n, dtype=torch.int32)
            assert t_kernel.grid(q, k, tables) == (
                4, B, -(-n * 16 // SPLIT))
            assert t_kernel.grid(q, k, tables, 64) == (4, B, -(-n * 16 // 64))
    assert t_kernel.num_splits(16, 16, 128) == 2
    assert t_kernel.num_splits(5, 7, 64) == 1


def test_fused_wrapper_checks_new_arguments():
    """k_new/v_new shapes and dtypes, the lengths' dtype and the split
    length raise before any launch; CPU tensors raise."""
    q, kn, vn, k, v, tables, kv_len = (torch.from_numpy(a) for a in
                                       _decode_case([3, 20], 8, 4, 32, 16, 2,
                                                    seed=1))
    check = t_kernel.check_inputs
    with pytest.raises(ValueError, match="k_new"):
        check(q, k, v, tables, kv_len, kn[:1], vn[:1])
    with pytest.raises(ValueError, match="v_new"):
        check(q, k, v, tables, kv_len, kn, vn[:, :2])
    with pytest.raises(TypeError, match="k_new"):
        check(q, k, v, tables, kv_len, kn.double(), vn)
    with pytest.raises(ValueError, match="together"):
        check(q, k, v, tables, kv_len, kn, None)
    with pytest.raises(TypeError, match="int32"):
        check(q, k, v, tables, kv_len.long(), kn, vn)
    with pytest.raises(ValueError, match="CUDA"):
        check(q, k, v, tables, kv_len, kn, vn)
    with pytest.raises(TypeError, match="integers"):
        t_kernel.paged_decode_cuda(q, kn, vn, k, v, tables, kv_len.float())
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.paged_decode_cuda(q, kn, vn, k, v, tables, kv_len)
    with pytest.raises(ValueError, match="split_tokens"):
        t_kernel.paged_attention_cuda(q, k, v, tables, kv_len + 1,
                                      split_tokens=100)
    with pytest.raises(ValueError, match="CUDA"):
        t_decode_step(q, kn, vn, k, v, tables, kv_len, impl="cuda")
    with pytest.raises(ValueError):
        t_decode_step(q, kn, vn, k, v, tables, kv_len, impl="pallas")
