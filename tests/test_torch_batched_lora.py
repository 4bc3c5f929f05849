"""The port's segment-aligned batched LoRA against the JAX reference.

On the CPU the port runs its plain PyTorch version (``ref``); it is held
against JAX's Pallas kernel in interpret mode and its jnp oracle at the
shapes of tests/test_kernels.py, in fp32 (1e-4) and bf16 (5e-2), the
tolerances there.  The port's copy of ``pack_segments`` returns exactly
what JAX's does.  The CUDA kernel itself runs only on the card: its tests
are in tests/test_torch_cuda_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.batched_lora.kernel import batched_lora_matmul as j_kernel
from repro.kernels.batched_lora.ops import pack_segments as j_pack
from repro.kernels.batched_lora.ref import batched_lora_ref as j_ref
from repro_torch.kernels.batched_lora import kernel as t_kernel
from repro_torch.kernels.batched_lora.ops import batched_lora, pack_segments
from repro_torch.kernels.batched_lora.ref import batched_lora_ref

try:  # the property test runs under hypothesis where it is installed
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = None

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
DTYPES = ["float32", "bfloat16"]
SHAPES = [  # T, D, F, G, r, bt, bf (tests/test_kernels.py)
    (256, 128, 256, 4, 16, 128, 128),
    (512, 256, 512, 2, 8, 128, 256),
    (128, 64, 128, 1, 4, 128, 128),
]


def make_inputs(T, D, F, G, r, bt, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32)
    a = (rng.standard_normal((G, D, r)) / np.sqrt(D)).astype(np.float32)
    b = (rng.standard_normal((G, r, F)) / np.sqrt(r)).astype(np.float32)
    tiles = rng.randint(0, G, size=-(-T // bt)).astype(np.int32)
    return x, w, a, b, tiles


def _both(arrays, dtype):
    *floats, tiles = arrays
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in floats]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in floats]
    return j + [jnp.asarray(tiles)], t + [torch.from_numpy(tiles)]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,D,F,G,r,bt,bf", SHAPES)
def test_ref_matches_pallas_interpret_and_jax_ref(T, D, F, G, r, bt, bf,
                                                  dtype):
    j, t = _both(make_inputs(T, D, F, G, r, bt), dtype)
    got = batched_lora(*t, bt=bt, scaling=0.5)  # auto: CPU -> ref
    assert got.dtype == t[0].dtype and got.shape == (T, F)
    _close(got, j_ref(*j, bt=bt, scaling=0.5), dtype)
    _close(got, j_kernel(*j, bt=bt, bf=bf, scaling=0.5, interpret=True),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_rows(dtype):
    """T not a multiple of bt: the ragged last tile's rows equal JAX's on
    the input padded to whole tiles."""
    T, D, F, G, r, bt = 200, 64, 96, 3, 8, 128
    x, w, a, b, tiles = make_inputs(T, D, F, G, r, bt, seed=9)
    xp = np.zeros((256, D), np.float32)
    xp[:T] = x
    j, _ = _both((xp, w, a, b, tiles), dtype)
    _, t = _both((x, w, a, b, tiles), dtype)
    got = batched_lora(*t, bt=bt, impl="ref")
    assert got.shape == (T, F)
    _close(got, np.asarray(j_ref(*j, bt=bt), np.float32)[:T], dtype)


def _pack_cases():
    rng = np.random.RandomState(0)
    for n_groups, reps, bt in [(2, 1, 4), (6, 5, 64), (3, 2, 7)] + [
            tuple(int(v) for v in (rng.randint(2, 7), rng.randint(1, 6),
                                   rng.randint(4, 65))) for _ in range(5)]:
        yield n_groups, reps, bt


def _check_pack(n_groups, reps, bt):
    """tests/test_properties.py's partition property, and the exact
    arrays JAX's ``pack_segments`` returns."""
    rng = np.random.RandomState(n_groups * 7 + reps)
    group_ids = rng.randint(0, n_groups, size=n_groups * reps * 3)
    order, tiles, padded = pack_segments(group_ids, bt=bt)
    j_order, j_tiles, j_padded = j_pack(group_ids, bt=bt)
    assert padded == j_padded
    np.testing.assert_array_equal(order, j_order)
    np.testing.assert_array_equal(tiles, j_tiles)
    assert order.dtype == j_order.dtype and tiles.dtype == j_tiles.dtype
    assert padded % bt == 0 and len(tiles) == padded // bt
    assert sorted(r for r in order if r >= 0) == list(range(len(group_ids)))
    for t_idx, g in enumerate(tiles):
        for row in order[t_idx * bt:(t_idx + 1) * bt]:
            assert row < 0 or group_ids[row] == g


@pytest.mark.parametrize("n_groups,reps,bt", list(_pack_cases()))
def test_pack_segments_matches_jax(n_groups, reps, bt):
    _check_pack(n_groups, reps, bt)


if given is not None:

    @given(st.integers(2, 6), st.integers(1, 5), st.integers(4, 64))
    @settings(max_examples=25, deadline=None, database=None)
    def test_pack_segments_matches_jax_property(n_groups, reps, bt):
        _check_pack(n_groups, reps, bt)


def test_packed_rows_get_their_own_adapter():
    """Rows packed by pack_segments through the batched product equal each
    row's own x @ W + s (x @ A[g]) @ B[g]."""
    T, D, F, G, r, bt = 40, 32, 48, 3, 4, 8
    x, w, a, b, _ = make_inputs(T, D, F, G, r, bt, seed=4)
    gid = np.random.RandomState(5).randint(0, G, size=T)
    order, tiles, padded = pack_segments(gid, bt=bt)
    xp = np.where((order >= 0)[:, None], x[np.maximum(order, 0)], 0.0)
    got = batched_lora_ref(torch.from_numpy(xp.astype(np.float32)),
                           torch.from_numpy(w), torch.from_numpy(a),
                           torch.from_numpy(b), torch.from_numpy(tiles),
                           bt=bt, scaling=0.5).numpy()
    want = x @ w + 0.5 * np.einsum("td,tdr,trf->tf", x, a[gid], b[gid])
    real = order >= 0
    np.testing.assert_allclose(got[real], want[order[real]], rtol=1e-5,
                               atol=1e-5)


def test_cuda_impl_on_cpu_raises_and_launches_nothing():
    _, t = _both(make_inputs(64, 32, 64, 1, 4, 64), "float32")
    before = t_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        batched_lora(*t, bt=64, impl="cuda")
    with pytest.raises(ValueError):
        batched_lora(*t, bt=64, impl="interpret")
    batched_lora(*t, bt=64)  # auto on the CPU: the plain version
    assert t_kernel.launches == before
