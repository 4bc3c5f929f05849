"""The port's flash attention forward against the JAX reference.

On the CPU the port runs its plain PyTorch version (``ref``); it is held
against JAX's Pallas kernel in interpret mode and its jnp oracle at the
shapes of tests/test_kernels.py, causal and not, in fp32 (2e-5) and bf16
(2e-2); at ragged S (which the Pallas kernel does not take) against the
jnp oracle; and against ``layers.causal_attention``, the attention the
JAX serving path's prefill runs, with and without its sliding window
(which the Pallas kernel does not take).  The CUDA kernel itself runs only
on the card: its tests are in tests/test_torch_cuda_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd as j_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro_torch.kernels.flash_attention import kernel as t_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ["float32", "bfloat16"]


def make_inputs(B, Hq, KVH, S, hd, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, S, hd), (B, KVH, S, hd), (B, KVH, S, hd)))


def _both(arrays, dtype):
    j = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    t = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    return j, t


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 8, 2, 256, 64), (1, 4, 4, 128, 32)])
def test_ref_matches_jax_ref(shape, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(make_inputs(*shape), dtype)
    got = flash_attention(tq, tk, tv, causal=causal)  # auto: CPU -> ref
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, j_ref(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("causal,dtype", [(True, "float32"),
                                          (False, "float32"),
                                          (True, "bfloat16")])
def test_ref_matches_pallas_interpret(causal, dtype):
    """Interpret mode is slow on the CPU: the GQA shape only."""
    (jq, jk, jv), (tq, tk, tv) = _both(make_inputs(2, 8, 2, 256, 64, seed=1),
                                       dtype)
    want = j_kernel(jq, jk, jv, bq=128, bk=128, causal=causal,
                    interpret=True)
    _close(flash_attention_ref(tq, tk, tv, causal=causal), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 17, 100])
def test_ragged_lengths_match_jax_ref(S, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(make_inputs(2, 8, 4, S, 32, seed=S),
                                       dtype)
    _close(flash_attention(tq, tk, tv, impl="ref"), j_ref(jq, jk, jv), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ref_matches_jax_causal_attention(dtype):
    """The JAX prefill path's attention, (B, S, H, hd) layout, at a narrow
    TinyLlama-like shape (Hq=4, KVH=2, hd=32, S=96, query chunk 16).  JAX
    rounds P to bf16 before P @ V there; the tolerance covers it."""
    from repro.models.layers import causal_attention

    q, k, v = make_inputs(2, 4, 2, 96, 32, seed=5)
    (jq, jk, jv), (tq, tk, tv) = _both(
        [a.transpose(0, 2, 1, 3).copy() for a in (q, k, v)], dtype)
    want = causal_attention(jq, jk, jv, chunk=16)
    got = flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                          tv.transpose(1, 2), impl="ref").transpose(1, 2)
    _close(got, want, dtype)


def test_ref_on_transposed_views_equals_contiguous():
    q, k, v = (torch.from_numpy(a.transpose(0, 2, 1, 3).copy())
               for a in make_inputs(2, 8, 2, 40, 32, seed=3))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    got = flash_attention(*views, impl="ref")
    want = flash_attention(*(t.contiguous() for t in views), impl="ref")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cuda_impl_on_cpu_raises_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in make_inputs(1, 4, 2, 8, 32))
    before = t_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError):
        flash_attention(q, k, v, impl="pallas")
    flash_attention(q, k, v)  # auto on the CPU: the plain version
    assert t_kernel.launches == before


# S, W, G, hd: inside the window, one past it, past it twice and off the
# 64-key tiles, a window that is not a multiple of 64, and rows in more
# than one of the plain version's query chunks (1,024 rows)
WINDOW_CASES = [(40, 64, 1, 64), (64, 64, 6, 80), (65, 64, 6, 80),
                (65, 64, 1, 128), (145, 64, 1, 128), (145, 64, 6, 64),
                (97, 40, 6, 128), (200, 40, 1, 80), (41, 40, 6, 64),
                (1100, 300, 1, 64)]


@pytest.mark.parametrize("S,W,G,hd", WINDOW_CASES)
def test_windowed_ref_matches_jax_causal_attention(S, W, G, hd):
    """``window=W``: row i keeps keys i - W < j <= i, as the JAX prefill's
    ``layers.causal_attention(window=W)`` (fp32, query chunk 32), within
    2e-5; the plain version's chunks hold only each chunk's window span."""
    from repro.models.layers import causal_attention

    q, k, v = make_inputs(1, 2 * G, 2, S, hd, seed=S + W + G + hd)
    (jq, jk, jv), (tq, tk, tv) = _both(
        [a.transpose(0, 2, 1, 3).copy() for a in (q, k, v)], "float32")
    want = causal_attention(jq, jk, jv, chunk=32, window=W)
    got = flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                          tv.transpose(1, 2), window=W,
                          impl="ref").transpose(1, 2)
    _close(got, want, "float32")
    if S <= W:  # the window masks nothing there
        _close(got, causal_attention(jq, jk, jv, chunk=32), "float32")


@pytest.mark.parametrize("causal,window,match", [
    (False, 8, "causal"), (True, -1, "window -1")])
def test_window_refusals(causal, window, match):
    """A window without causal (the reference has none) and a negative
    window raise on the plain version and in the kernel's wrapper, before
    any launch."""
    q, k, v = (torch.from_numpy(a) for a in make_inputs(1, 4, 2, 16, 32))
    before = t_kernel.launches
    for fn in (flash_attention_ref,
               lambda *a, **kw: flash_attention(*a, **kw, impl="ref"),
               t_kernel.flash_attention_cuda):
        with pytest.raises(ValueError, match=match):
            fn(q, k, v, causal=causal, window=window)
    assert t_kernel.launches == before
