"""The PyTorch port's encoder-decoder (seamless-m4t-medium:
``models/encdec.py``) behind the Model API, against the JAX reference at
the reduced config.

The reference's fp32 side runs in a subprocess with
``REPRO_COMPUTE_DTYPE=float32``: it draws the parameters, encodes numpy
frames, prefills the decoder on padded target prompts and runs four
teacher-forced decode steps, the first three with ``src_len`` shorter
than the source for two rows and the last without it (all frames).  The
port gets the trees through ``params_from_numpy``.  Its bf16 side runs
against this process's JAX, which computes in bf16.

Tolerances: fp32 at rtol/atol 2e-5 on the plain route (``auto`` on the
CPU) and the kernels' plain versions (``ref``: flash's, non-causal in the
encoder, and paged's over the caches' one-page-per-sequence views); bf16
per step as ``test_torch_model_api.py`` states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.model import (
    build_model,
    cache_from_numpy,
    params_from_numpy,
)
from test_torch_model_api import (
    TOL,
    _check_cache,
    _close_bf16,
    _tokens_agree,
    _torch_batch,
    jax_fp32_pickle,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NAME = "seamless-m4t-medium"
B, S_SRC, S, PLENS, MAX_LEN = 4, 20, 12, (12, 9, 7, 12), 16
SRC_LEN = (20, 20, 15, 11)
STEPS = 4


def inputs():
    """numpy (batch, decode batches): frames 0.5 N(0, 1); the last decode
    step has no ``src_len``."""
    cfg = get_reduced_config(NAME)
    rng = np.random.RandomState(30)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "prompt_lens": np.asarray(PLENS, np.int32),
             "frames": (0.5 * rng.standard_normal((B, S_SRC, cfg.d_model)))
             .astype(np.float32)}
    steps = []
    for j in range(STEPS):
        st = {"tokens": rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32),
              "kv_len": (np.asarray(PLENS) + j).astype(np.int32)}
        if j < STEPS - 1:
            st["src_len"] = np.asarray(SRC_LEN, np.int32)
        steps.append(st)
    return batch, steps


_JAX_ENCDEC = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_encdec import MAX_LEN, NAME, inputs
from repro.configs import get_reduced_config
from repro.models import encdec as E
from repro.models.model import build_model

as_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
cfg = get_reduced_config(NAME)
params = build_model(cfg).init(jax.random.PRNGKey(0))
batch, steps = inputs()
jb = jax.tree.map(jnp.asarray, batch)
out = {{"params": as_np(params),
       "enc": as_np(E.encode(params, cfg, jb["frames"]))}}
logits, cache, _ = E.encdec_prefill(params, cfg, jb, max_len=MAX_LEN)
out.update(logits=as_np(logits), cache=as_np(cache), steps=[])
for st in steps:
    lg, cache = E.encdec_decode_step(params, cfg, cache,
                                     jax.tree.map(jnp.asarray, st))
    out["steps"].append(as_np(lg))
out["final_cache"] = as_np(cache)
pickle.dump(out, open({out!r}, "wb"))
"""


@pytest.fixture(scope="module")
def ref():
    torch.set_num_threads(1)
    return jax_fp32_pickle(_JAX_ENCDEC)


def _reset_routes():
    for d in (T.PREFILL_ROUTES, T.DECODE_ROUTES):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# configs and shapes
# ---------------------------------------------------------------------------


def test_specs_equal_the_reference():
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get
    from repro.models.model import build_model as j_build
    from repro_torch.configs import SHAPES

    mine, theirs = build_model(get_config(NAME)), j_build(j_get(NAME))

    def flat(t, p=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in flat(v, f"{p}/{k}").items()}
        return {p: (tuple(t.shape), str(t.dtype).split(".")[-1])}

    assert flat(mine.param_shapes()) == flat(theirs.param_shapes())
    for shape in ("prefill_32k", "decode_32k", "train_4k"):
        got = mine.batch_specs(SHAPES[shape])
        want = theirs.batch_specs(J_SHAPES[shape])
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}, shape
        assert all(v.device.type == "meta" for v in got.values())
    assert flat(mine.cache_specs(SHAPES["decode_32k"])) == \
        flat(theirs.cache_specs(J_SHAPES["decode_32k"]))


def test_params_and_cache_from_numpy_check_the_trees(ref):
    cfg = get_reduced_config(NAME)
    params_from_numpy(cfg, ref["params"], "cpu")
    bad = dict(ref["params"], decoder=dict(ref["params"]["decoder"]))
    bad["decoder"]["xwq"] = bad["decoder"]["xwq"][:, :, :-1]
    with pytest.raises(ValueError, match="xwq"):
        params_from_numpy(cfg, bad, "cpu")
    cache = cache_from_numpy(cfg, ref["cache"], "cpu",
                             compute_dtype=torch.float32)
    assert cache["xk"].shape[2] == S_SRC and cache["k"].shape[2] == MAX_LEN
    with pytest.raises(ValueError, match="keys"):
        cache_from_numpy(cfg, {k: v for k, v in ref["cache"].items()
                               if k != "xv"}, "cpu",
                         compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,sk,chunk", [(12, 20, 16), (20, 20, 8),
                                         (5, 33, 4)])
def test_bidir_attention_matches_jax_fp32(sq, sk, chunk):
    """Cross-attention's plain route (queries and keys of different
    lengths) and the encoder's (equal lengths), query-chunked."""
    from repro.models import encdec as JE

    rng = np.random.RandomState(31)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 4, 16)).astype(np.float32)
            for _ in range(2))
    want = JE.bidir_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              chunk)
    got = E.bidir_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


@pytest.mark.parametrize("attn_impl", ["auto", "ref"])
def test_encode_matches_jax_fp32(ref, attn_impl):
    """The encoder: plain bidirectional attention (``auto`` on the CPU) or
    flash's plain version with ``causal=False`` (``ref``)."""
    cfg = get_reduced_config(NAME)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    batch, _ = inputs()
    _reset_routes()
    got = E.encode(params, cfg, torch.from_numpy(batch["frames"]),
                   attn_impl=attn_impl, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref["enc"], **TOL["float32"])
    route = "plain" if attn_impl == "auto" else "flash_ref"
    assert T.PREFILL_ROUTES[route] == cfg.encoder_layers


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["auto", "ref"])
def test_encdec_matches_jax_fp32(ref, attn_impl):
    """fp32: prefill logits and the cache (``k``/``v``/``xk``/``xv``), each
    teacher-forced decode step's logits (``src_len`` shorter than the
    source for two rows, then omitted) and the final cache; every route
    counted; ``xk``/``xv`` bitwise unchanged by decode."""
    cfg = get_reduced_config(NAME)
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    batch, steps = inputs()
    _reset_routes()
    logits, cache, plens = model.prefill(params, _torch_batch(batch),
                                         max_len=MAX_LEN, attn_impl=attn_impl)
    np.testing.assert_allclose(logits.numpy(), ref["logits"],
                               **TOL["float32"])
    np.testing.assert_array_equal(plens.numpy(), PLENS)
    _check_cache(cache, ref["cache"], cfg)
    xk, xv = cache["xk"].clone(), cache["xv"].clone()
    for j, st in enumerate(steps):
        lg, cache = model.decode_step(params, cache, _torch_batch(st),
                                      attn_impl=attn_impl)
        np.testing.assert_allclose(lg.numpy(), ref["steps"][j],
                                   **TOL["float32"], err_msg=f"step {j}")
    _check_cache(cache, ref["final_cache"], cfg)
    assert torch.equal(cache["xk"], xk) and torch.equal(cache["xv"], xv)
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    self_route = "plain" if attn_impl == "auto" else "flash_ref"
    assert T.PREFILL_ROUTES == {k: {self_route: Le + Ld, "cross_plain": Ld}
                                .get(k, 0) for k in T.PREFILL_ROUTES}
    dec = "plain" if attn_impl == "auto" else "paged_ref"
    assert T.DECODE_ROUTES == {
        k: Ld * STEPS * (k in (dec, "cross_" + dec)) for k in T.DECODE_ROUTES}


def test_src_len_masks_the_source(ref):
    """Decode's cross-attention stops at ``src_len``: shifting row 3's
    cross K/V past its 11 frames moves nothing, on the plain route and the
    paged kernel's plain version; shifting them inside does."""
    cfg = get_reduced_config(NAME)
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    _, steps = inputs()
    st = _torch_batch(steps[0])
    n = SRC_LEN[3]

    def step(where, impl):
        cache = cache_from_numpy(cfg, ref["cache"], "cpu",
                                 compute_dtype=torch.float32)
        for name in ("xk", "xv"):
            cache[name][:, 3, where] += 5.0
        return model.decode_step(params, cache, st, attn_impl=impl)[0][3]

    want = torch.from_numpy(ref["steps"][0][3])
    for impl in ("auto", "ref"):
        np.testing.assert_allclose(step(slice(n, None), impl).numpy(),
                                   want.numpy(), **TOL["float32"])
        assert not np.allclose(step(slice(0, n), impl).numpy(),
                               want.numpy(), atol=1e-3)


def test_encdec_matches_jax_bf16(ref):
    """bf16 (this process's JAX computes in bf16): logits per step within
    2e-2 plus one bf16 ulp, greedy tokens equal at a clear margin."""
    from repro.configs import get_reduced_config as j_get
    from repro.models import encdec as JE
    from repro.models import layers as JL

    assert JL.COMPUTE_DTYPE == jnp.bfloat16
    cfg, jcfg = get_reduced_config(NAME), j_get(NAME)
    batch, steps = inputs()
    jparams = jax.tree.map(jnp.asarray, ref["params"])
    params = params_from_numpy(cfg, ref["params"], "cpu")
    model = build_model(cfg)
    tl, tc, _ = model.prefill(params, _torch_batch(batch), max_len=MAX_LEN)
    jl, jc, _ = JE.encdec_prefill(jparams, jcfg,
                                  jax.tree.map(jnp.asarray, batch),
                                  max_len=MAX_LEN)
    assert tl.dtype == torch.bfloat16 and tc["xk"].dtype == torch.bfloat16
    _close_bf16(tl, jl, "prefill")
    clear = _tokens_agree(tl, jl)
    for j, st in enumerate(steps):
        tl, tc = model.decode_step(params, tc, _torch_batch(st))
        jl, jc = JE.encdec_decode_step(jparams, jcfg, jc,
                                       jax.tree.map(jnp.asarray, st))
        _close_bf16(tl, jl, f"step {j}")
        clear += _tokens_agree(tl, jl)
    assert clear > 0
