"""The port's paged decode attention against the JAX reference.

On the CPU the port runs its plain PyTorch version (``ref``); it is held
against JAX's Pallas kernel in interpret mode and against JAX's jnp oracle,
at the shapes of tests/test_kernels.py, at the demo engine's shape
(page 16, hd 32, Hq 8, KVH 4) and at a narrow G=8 case, in fp32 (2e-5) and
bf16 (2e-2).  The CUDA kernel itself runs only on the card: its tests are
in tests/test_torch_cuda_kernels.py (no JAX there, so they run on the card).
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
