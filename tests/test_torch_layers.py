"""The PyTorch port's layers against the JAX reference: the same numpy
inputs through ``repro.models`` and ``repro_torch.models``, in fp32
(rtol/atol 2e-5) and bf16 (2e-2, the tolerances of tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ["float32", "bfloat16"]


def _pair(x, dtype):
    x = np.asarray(x, np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x.copy()).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_configs_are_copies():
    for name in ("blockllm-demo", "tinyllama-1.1b"):
        j, t = j_get_config(name), t_get_config(name)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "resolved_head_dim", "attn_chunk",
                  "rope_theta", "norm_eps", "sliding_window"):
            assert getattr(t, f) == getattr(j, f), (name, f)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.RandomState(0)
    x = 3.0 * rng.standard_normal((2, 5, 64))
    scale = 1.0 + 0.1 * rng.standard_normal(64)
    jx, tx = _pair(x, dtype)
    want = JL.rms_norm(jx, jnp.asarray(scale, jnp.float32), 1e-5)
    got = TL.rms_norm(tx, torch.from_numpy(scale.astype(np.float32)), 1e-5)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [32, 64])
def test_apply_rope(dtype, hd):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 7, 3, hd))
    pos = rng.randint(0, 300, size=(2, 7)).astype(np.int32)
    jx, tx = _pair(x, dtype)
    want = JL.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    got = TL.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    _close(got, want, dtype)
    np.testing.assert_allclose(TL.rope_freqs(hd, 10_000.0).numpy(),
                               np.asarray(JL.rope_freqs(hd, 10_000.0)),
                               rtol=1e-6)


def test_apply_rope_rejects_mrope():
    with pytest.raises(NotImplementedError):
        TL.apply_rope(torch.zeros(1, 2, 1, 8), torch.zeros(1, 2, 3), 1e4,
                      mrope_sections=(2, 1, 1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,chunk,Hq,KVH", [
    (16, 16, 4, 2),    # one chunk
    (37, 16, 8, 4),    # ragged: query side padded to 48
    (9, 64, 4, 1),     # chunk larger than S (clamped)
    (40, 8, 2, 2),     # many chunks, MHA
])
def test_causal_attention(dtype, S, chunk, Hq, KVH):
    rng = np.random.RandomState(2)
    hd = 32
    q = rng.standard_normal((2, S, Hq, hd))
    k = rng.standard_normal((2, S, KVH, hd))
    v = rng.standard_normal((2, S, KVH, hd))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = JL.causal_attention(jq, jk, jv, chunk=chunk)
    got = TL.causal_attention(tq, tk, tv, chunk=chunk)
    assert got.shape == (2, S, Hq, hd)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_layer(dtype):
    cfg_j = j_get_config("blockllm-demo")
    cfg_t = t_get_config("blockllm-demo")
    rng = np.random.RandomState(3)
    D, F = cfg_j.d_model, cfg_j.d_ff
    p = {"ln2": 1.0 + 0.1 * rng.standard_normal(D),
         "w_gate": rng.standard_normal((D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((F, D)) / np.sqrt(F)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 6, D))
    jx, tx = _pair(x, dtype)
    want = JT._mlp_layer(jx, {k: jnp.asarray(v) for k, v in p.items()},
                         cfg_j, None)
    got = TT._mlp_layer(tx, {k: torch.from_numpy(v) for k, v in p.items()},
                        cfg_t)
    _close(got, want, dtype)


def test_dense_init_is_seeded_truncated_normal():
    g = torch.Generator().manual_seed(0)
    a = TL.dense_init(g, (256, 64))
    b = TL.dense_init(torch.Generator().manual_seed(0), (256, 64))
    assert a.dtype == torch.float32 and torch.equal(a, b)
    std = 1.0 / 16.0
    assert float(a.abs().max()) <= 2.0 * std + 1e-7
    # a +-2 sigma truncated unit normal has std ~0.880
    assert abs(float(a.std()) / std - 0.880) < 0.02
