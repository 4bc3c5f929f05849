"""The PyTorch port's SSM family (xlstm: ``models/xlstm.py``) behind the
Model API, against the JAX reference at ``xlstm-125m-reduced`` (an mLSTM
and an sLSTM block, d_model 64, 4 heads, query chunks of 16).

The reference's fp32 side runs in a subprocess with
``REPRO_COMPUTE_DTYPE=float32``: per case it draws the parameters, runs
``xlstm_prefill`` (the mLSTM's parallel form over two query chunks, its
final state from the recurrence, the sLSTM's scan) and then teacher-forced
``xlstm_decode_step``s.  The cases: 20 tokens, and a ragged batch of 13.
The port gets the trees through ``params_from_numpy``; its bf16 side runs
against this process's JAX, which computes in bf16.

Tolerances: fp32 at rtol/atol 2e-5 (``tests/test_kernels.py``) for logits
and every state tensor; bf16 per step as ``test_torch_model_api.py``
states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.models.model import (
    build_model,
    cache_from_numpy,
    params_from_numpy,
)
from test_torch_model_api import (
    TOL,
    _close_bf16,
    _tokens_agree,
    _torch_batch,
    jax_fp32_pickle,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NAME = "xlstm-125m"
# case -> (B, S, prompt_lens, decode steps)
CASES = {
    "full": (2, 20, (20, 20), 6),       # two query chunks, the last short
    "ragged": (3, 13, (13, 8, 3), 6),
}


def case_inputs(case: str):
    """numpy inputs of a case: (batch, decode batches)."""
    B, S, plens, n_dec = CASES[case]
    cfg = get_reduced_config(NAME)
    rng = np.random.RandomState(sorted(CASES).index(case) + 40)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens[np.arange(S)[None] >= np.asarray(plens)[:, None]] = 0
    batch = {"tokens": tokens, "prompt_lens": np.asarray(plens, np.int32)}
    steps = [{"tokens": rng.randint(0, cfg.vocab_size, (B, 1)).astype(
        np.int32), "kv_len": (np.asarray(plens) + j).astype(np.int32)}
        for j in range(n_dec)]
    return batch, steps


_JAX_XLSTM = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_xlstm import CASES, NAME, case_inputs
from repro.configs import get_reduced_config
from repro.models import xlstm as X
from repro.models.model import build_model

as_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
cfg = get_reduced_config(NAME)
params = build_model(cfg).init(jax.random.PRNGKey(1))
out = {{"params": as_np(params)}}
for case in sorted(CASES):
    batch, steps = case_inputs(case)
    logits, cache, _ = X.xlstm_prefill(params, cfg,
                                       jax.tree.map(jnp.asarray, batch))
    rec = {{"logits": as_np(logits), "cache": as_np(cache), "steps": []}}
    for st in steps:
        lg, cache = X.xlstm_decode_step(params, cfg, cache,
                                        jax.tree.map(jnp.asarray, st))
        rec["steps"].append(as_np(lg))
    rec["final_cache"] = as_np(cache)
    out[case] = rec
pickle.dump(out, open({out!r}, "wb"))
"""


@pytest.fixture(scope="module")
def ref():
    torch.set_num_threads(1)
    return jax_fp32_pickle(_JAX_XLSTM)


def _check_states(got, want, what=""):
    assert len(got) == len(want), what
    for i, (g_blk, w_blk) in enumerate(zip(got, want)):
        assert len(g_blk) == len(w_blk)
        for j, (g, w) in enumerate(zip(g_blk, w_blk)):
            assert tuple(g.shape) == w.shape, (what, i, j)
            np.testing.assert_allclose(g.numpy(), w, **TOL["float32"],
                                       err_msg=f"{what} block {i} [{j}]")


def _flat(t, p=""):
    if isinstance(t, dict):
        return {k2: v2 for k, v in t.items()
                for k2, v2 in _flat(v, f"{p}/{k}").items()}
    if isinstance(t, (list, tuple)):
        return {k2: v2 for i, v in enumerate(t)
                for k2, v2 in _flat(v, f"{p}/{i}").items()}
    return {p: (tuple(t.shape), str(t.dtype).split(".")[-1])}


# ---------------------------------------------------------------------------
# shapes and init
# ---------------------------------------------------------------------------


def test_specs_equal_the_reference():
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get
    from repro.models.model import build_model as j_build
    from repro_torch.configs import SHAPES

    mine, theirs = build_model(get_config(NAME)), j_build(j_get(NAME))
    assert _flat(mine.param_shapes()) == _flat(theirs.param_shapes())
    for shape in ("decode_32k", "long_500k"):
        assert _flat(mine.cache_specs(SHAPES[shape])) == \
            _flat(theirs.cache_specs(J_SHAPES[shape])), shape


def test_init_keeps_the_reference_deterministic_parts():
    cfg = get_reduced_config(NAME)
    p = X.init_xlstm(cfg, torch.Generator().manual_seed(0), device="cpu")
    m, s = p["blocks"]
    assert (m["b_f"] == 3.0).all() and (m["b_i"] == 0).all()
    assert (s["b_gates"][1] == 3.0).all()
    assert (s["b_gates"][[0, 2, 3]] == 0).all()
    # r_gates ~ 0.1 N(0, 1) / sqrt(dh)
    dh = cfg.d_model // cfg.num_heads
    assert float(s["r_gates"].std()) == pytest.approx(0.1 / dh ** 0.5,
                                                      rel=0.2)


# ---------------------------------------------------------------------------
# the mLSTM's two forms and the sLSTM's scan, piece by piece
# ---------------------------------------------------------------------------


def _mlstm_inputs(B, S, H, dk, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((B, S, H, dk)).astype(np.float32)
               for _ in range(3))
    i_raw = rng.standard_normal((B, S, H)).astype(np.float32)
    f_raw = (2.0 + rng.standard_normal((B, S, H))).astype(np.float32)
    return q, k, v, i_raw, f_raw


@pytest.mark.parametrize("S,chunk", [(20, 16), (16, 16), (7, 16), (12, 4)])
def test_mlstm_parallel_equals_the_step_unrolled(S, chunk):
    """The parallel form over query chunks against ``_mlstm_step`` unrolled
    from (0, 0, -1e30) (fp32, 2e-5), against the reference's parallel
    form, and ``mlstm_final_state`` against the unrolled state."""
    from repro.models import xlstm as JX

    arrs = _mlstm_inputs(2, S, 3, 8, S + chunk)
    t = [torch.from_numpy(a) for a in arrs]
    y = X._mlstm_parallel(*t, chunk)
    state = (torch.zeros(2, 3, 8, 8), torch.zeros(2, 3, 8),
             torch.full((2, 3), -1e30))
    ys = []
    for i in range(S):
        yi, state = X._mlstm_step(*(a[:, i] for a in t), state)
        ys.append(yi)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               **TOL["float32"])
    want = JX._mlstm_parallel(*(jnp.asarray(a) for a in arrs), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL["float32"])
    for got, w in zip(X.mlstm_final_state(*t), state):
        assert torch.equal(got, w)


def test_slstm_scan_matches_jax():
    from repro.models import xlstm as JX

    rng = np.random.RandomState(3)
    g_in = rng.standard_normal((2, 9, 4, 3, 5)).astype(np.float32)
    r = (0.3 * rng.standard_normal((4, 3, 5, 5))).astype(np.float32)
    z = np.zeros((2, 3, 5), np.float32)
    state = (z, z, z, np.full((2, 3, 5), -1e30, np.float32))
    want_h, want_st = JX._slstm_scan(jnp.asarray(g_in), jnp.asarray(r),
                                     tuple(jnp.asarray(a) for a in state))
    before = X.LOOP_STEPS["slstm_scan"]
    got_h, got_st = X._slstm_scan(torch.from_numpy(g_in), torch.from_numpy(r),
                                  tuple(torch.from_numpy(a) for a in state))
    assert X.LOOP_STEPS["slstm_scan"] == before + 9
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               **TOL["float32"])
    for g, w in zip(got_st, want_st):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL["float32"])


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_xlstm_matches_jax_fp32(ref, case):
    """fp32: prefill logits, every block's state, each teacher-forced decode
    step's logits and the final states; no attention route is taken, and
    the two time loops step once per position and block."""
    cfg = get_reduced_config(NAME)
    batch, steps = case_inputs(case)
    r = ref[case]
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    for d in (T.PREFILL_ROUTES, T.DECODE_ROUTES, X.LOOP_STEPS):
        for k in d:
            d[k] = 0
    logits, cache, _ = model.prefill(params, _torch_batch(batch))
    B, S = batch["tokens"].shape
    n_m = (cfg.num_layers + 1) // 2
    assert X.LOOP_STEPS == {"mlstm_final_state": n_m * S,
                            "slstm_scan": (cfg.num_layers - n_m) * S}
    np.testing.assert_allclose(logits.numpy(), r["logits"], **TOL["float32"])
    _check_states(cache, r["cache"], "prefill")
    for j, st in enumerate(steps):
        lg, cache = model.decode_step(params, cache, _torch_batch(st))
        np.testing.assert_allclose(lg.numpy(), r["steps"][j],
                                   **TOL["float32"], err_msg=f"step {j}")
    _check_states(cache, r["final_cache"], "final")
    assert not any(T.PREFILL_ROUTES.values())
    assert not any(T.DECODE_ROUTES.values())


def test_decode_from_the_reference_state(ref):
    """``cache_from_numpy`` takes the reference's state tuples; decoding
    from them equals the reference's steps (fp32), and updates them in
    place."""
    cfg = get_reduced_config(NAME)
    _, steps = case_inputs("ragged")
    r = ref["ragged"]
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    cache = cache_from_numpy(cfg, r["cache"], "cpu",
                             compute_dtype=torch.float32)
    first = cache[0][0]
    for j, st in enumerate(steps):
        lg, out = model.decode_step(params, cache, _torch_batch(st))
        assert out is cache and out[0][0] is first
        np.testing.assert_allclose(lg.numpy(), r["steps"][j],
                                   **TOL["float32"], err_msg=f"step {j}")
    bad = (r["cache"][0][:2],) + tuple(r["cache"][1:])
    with pytest.raises(ValueError, match="keys"):
        cache_from_numpy(cfg, bad, "cpu", compute_dtype=torch.float32)


def test_ragged_rows_absorb_their_padding(ref):
    """As in the reference, prefill's recurrences run over the whole padded
    S: a ragged row's states differ from the same row prefilled alone at
    its length; a full-length row's equal it."""
    cfg = get_reduced_config(NAME)
    batch, _ = case_inputs("ragged")
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    _, cache, _ = model.prefill(params, _torch_batch(batch))
    for b, n in enumerate(batch["prompt_lens"]):
        alone = {"tokens": torch.from_numpy(batch["tokens"][b:b + 1, :n])}
        _, own, _ = model.prefill(params, alone)
        for i, (blk, own_blk) in enumerate(zip(cache, own)):
            same = all(torch.allclose(a[b], o[0], rtol=2e-5, atol=2e-5)
                       for a, o in zip(blk, own_blk))
            assert same == (n == batch["tokens"].shape[1]), (i, b, n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_xlstm_matches_jax_bf16(ref, case):
    """bf16 (this process's JAX computes in bf16): logits per step within
    2e-2 plus one bf16 ulp, greedy tokens equal where the margin is clear."""
    from repro.configs import get_reduced_config as j_get
    from repro.models import layers as JL
    from repro.models import xlstm as JX

    assert JL.COMPUTE_DTYPE == jnp.bfloat16
    cfg, jcfg = get_reduced_config(NAME), j_get(NAME)
    batch, steps = case_inputs(case)
    jparams = jax.tree.map(jnp.asarray, ref["params"])
    params = params_from_numpy(cfg, ref["params"], "cpu")
    model = build_model(cfg)
    tl, tc, _ = model.prefill(params, _torch_batch(batch))
    jl, jc, _ = JX.xlstm_prefill(jparams, jcfg, jax.tree.map(jnp.asarray,
                                                             batch))
    assert tl.dtype == torch.bfloat16
    _close_bf16(tl, jl, "prefill")
    clear = _tokens_agree(tl, jl)
    for j, st in enumerate(steps):
        tl, tc = model.decode_step(params, tc, _torch_batch(st))
        jl, jc = JX.xlstm_decode_step(jparams, jcfg, jc,
                                      jax.tree.map(jnp.asarray, st))
        _close_bf16(tl, jl, f"step {j}")
        clear += _tokens_agree(tl, jl)
    assert clear > 0
