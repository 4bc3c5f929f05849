"""The PyTorch port's hybrid family (zamba2: ``models/mamba2.py``) behind the
Model API, against the JAX reference at ``zamba2-2.7b-reduced`` (4 mamba
layers, d_model 64, SSD chunk 8, the shared block every 2 layers, a
sliding window of 32).

The reference's fp32 side runs in a subprocess with
``REPRO_COMPUTE_DTYPE=float32``: per case it draws the parameters, runs
``zamba_prefill`` on padded prompts and then teacher-forced
``zamba_decode_step``s.  The cases: S a multiple of the chunk (16) and not
(13), the latter ragged; a prompt past the window (40 in 32: its K/V kept
at their ring slots, prefill with the window on every route); a prompt
inside the window (28) whose decode crosses the ring of 32 (the fused
step, then the ring's insert and the attend-only route).  The port gets
the trees through ``params_from_numpy``.  Its bf16 side runs against
this process's JAX, which computes in bf16.

Tolerances: fp32 at rtol/atol 2e-5 (``tests/test_kernels.py``) for logits
and every cache tensor, the SSM state included; bf16 at the tolerance
``test_torch_model_api.py`` states (2e-2 plus one bf16 ulp), per step and
hop by hop: a whole bf16 chain of six hops drifts up to 1.54 times that
bound from JAX's, by a bf16 ulp or two a hop (JAX's own jitted and eager
shared block differ by one), so whole chains are held in fp32 and, in
bf16, by their greedy tokens at a clear margin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import mamba2 as Z
from repro_torch.models import transformer as T
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

NAME = "zamba2-2.7b"
# case -> (B, S, prompt_lens, max_len, decode steps)
CASES = {
    "chunked": (2, 16, (16, 16), 24, 6),   # S a multiple of the chunk
    "ragged": (3, 13, (13, 9, 5), 24, 6),  # S off the chunk, ragged rows
    "window": (2, 40, (40, 35), None, 6),  # S past the window of 32
    "ring": (2, 28, (28, 24), 48, 8),      # decode crosses the ring of 32
}


def case_inputs(case: str):
    """numpy inputs of a case: (batch, max_len, decode batches)."""
    B, S, plens, max_len, n_dec = CASES[case]
    cfg = get_reduced_config(NAME)
    rng = np.random.RandomState(sorted(CASES).index(case))
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens[np.arange(S)[None] >= np.asarray(plens)[:, None]] = 0
    batch = {"tokens": tokens, "prompt_lens": np.asarray(plens, np.int32)}
    steps = [{"tokens": rng.randint(0, cfg.vocab_size, (B, 1)).astype(
        np.int32), "kv_len": (np.asarray(plens) + j).astype(np.int32)}
        for j in range(n_dec)]
    return batch, max_len, steps


_JAX_ZAMBA = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_mamba2 import CASES, NAME, case_inputs
from repro.configs import get_reduced_config
from repro.models import mamba2 as Z
from repro.models.model import build_model

as_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
cfg = get_reduced_config(NAME)
params = build_model(cfg).init(jax.random.PRNGKey(0))
out = {{"params": as_np(params)}}
for case in sorted(CASES):
    batch, max_len, steps = case_inputs(case)
    logits, cache, _ = Z.zamba_prefill(params, cfg,
                                       jax.tree.map(jnp.asarray, batch),
                                       max_len=max_len)
    rec = {{"logits": as_np(logits), "cache": as_np(cache), "steps": []}}
    for st in steps:
        lg, cache = Z.zamba_decode_step(params, cfg, cache,
                                        jax.tree.map(jnp.asarray, st))
        rec["steps"].append(as_np(lg))
    rec["final_cache"] = as_np(cache)
    out[case] = rec
pickle.dump(out, open({out!r}, "wb"))
"""


@pytest.fixture(scope="module")
def ref():
    torch.set_num_threads(1)
    return jax_fp32_pickle(_JAX_ZAMBA)


def _reset_routes():
    for d in (T.PREFILL_ROUTES, T.DECODE_ROUTES):
        for k in d:
            d[k] = 0


def _check_tree(got, want, what=""):
    """Every tensor of a (nested) cache at the fp32 tolerance."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _check_tree(got[k], want[k], f"{what}/{k}")
        return
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               **TOL["float32"], err_msg=what)


# ---------------------------------------------------------------------------
# shapes
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
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        assert flat(mine.cache_specs(SHAPES[shape])) == \
            flat(theirs.cache_specs(J_SHAPES[shape])), shape


def test_init_keeps_the_reference_deterministic_parts():
    cfg = get_reduced_config(NAME)
    p = Z.init_zamba(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, H, _, conv_ch, _ = Z.mamba_dims(cfg)
    a_log = torch.log(torch.linspace(1.0, 16.0, H))
    assert torch.equal(p["mamba"]["A_log"][1, 0], a_log)
    assert (p["mamba"]["D_skip"] == 1).all()
    assert (p["mamba"]["conv_b"] == 0).all()
    # dt = softplus(dt_bias) lies in [1e-4, 1e-1]
    dt = torch.nn.functional.softplus(p["mamba"]["dt_bias"])
    assert (dt >= 1e-4 * (1 - 1e-5)).all() and (dt <= 0.1 * (1 + 1e-5)).all()
    assert p["shared_attn"]["w_concat"].shape == (2 * cfg.d_model,
                                                  cfg.d_model)
    assert p["mamba"]["conv_w"].shape == (2, 2, cfg.ssm_conv_width, conv_ch)


# ---------------------------------------------------------------------------
# the SSD scan and the conv, piece by piece
# ---------------------------------------------------------------------------


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    dt = rng.uniform(1e-3, 0.5, (B, S, H)).astype(np.float32)
    A = -np.exp(rng.uniform(0, 2, H)).astype(np.float32)
    return x, Bm, Cm, dt, A


@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 8), (5, 8), (24, 4)])
def test_ssd_scan_equals_the_step_recurrence(S, chunk):
    """The chunked scan against h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = C_t . h_t, step by step (fp32, 2e-5), and against the
    reference's ``ssd_scan``; also from a nonzero h0."""
    from repro.models import mamba2 as JZ

    x, Bm, Cm, dt, A = _ssd_inputs(2, S, 3, 4, 5, S + chunk)
    h0 = np.random.RandomState(1).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    t = [torch.from_numpy(a) for a in (x, Bm, Cm, dt, A)]
    for start in (None, h0):
        y, h = Z.ssd_scan(*t, chunk, None if start is None
                          else torch.from_numpy(start))
        hs = torch.zeros(2, 3, 4, 5) if start is None else \
            torch.from_numpy(start)
        ys = []
        for i in range(S):
            dA = torch.exp(t[3][:, i] * t[4])  # (B, H)
            hs = dA[:, :, None, None] * hs + torch.einsum(
                "bhp,bn->bhpn", t[0][:, i] * t[3][:, i][..., None], t[1][:, i])
            ys.append(torch.einsum("bn,bhpn->bhp", t[2][:, i], hs))
        np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                                   **TOL["float32"])
        np.testing.assert_allclose(h.numpy(), hs.numpy(), **TOL["float32"])
        jy, jh = JZ.ssd_scan(*(jnp.asarray(a) for a in (x, Bm, Cm, dt, A)),
                             chunk, None if start is None
                             else jnp.asarray(start))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   **TOL["float32"])
        np.testing.assert_allclose(h.numpy(), np.asarray(jh),
                                   **TOL["float32"])


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_causal_matches_jax(with_state):
    """The depthwise causal conv (width 4) with and without a carried
    state: output and new state against the reference's, and a
    sequence split in two with the state carried equals it whole."""
    from repro.models import mamba2 as JZ

    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state \
        else None
    want, want_st = JZ._conv1d_causal(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = Z._conv1d_causal(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    a, a_st = Z._conv1d_causal(torch.from_numpy(x[:, :4]), torch.from_numpy(w),
                               torch.from_numpy(b), None if st is None
                               else torch.from_numpy(st))
    c, c_st = Z._conv1d_causal(torch.from_numpy(x[:, 4:]), torch.from_numpy(w),
                               torch.from_numpy(b), a_st)
    np.testing.assert_allclose(torch.cat([a, c], 1).numpy(), got.numpy(),
                               **TOL["float32"])
    assert torch.equal(c_st, got_st)


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------


FP32_RUNS = [(c, impl) for c in sorted(CASES) for impl in ("auto", "ref")]


@pytest.mark.parametrize("case,attn_impl", FP32_RUNS)
def test_zamba_matches_jax_fp32(ref, case, attn_impl):
    """fp32: prefill logits, the cache (``attn`` K/V, ``conv``, ``ssm``),
    every teacher-forced decode step's logits and the final cache, on the
    plain route (``auto`` on the CPU) and the kernels' plain versions
    (``ref``); the routes counted.  The window case's prompt is past the
    window: flash's plain version takes the window, as the plain route
    does."""
    cfg = get_reduced_config(NAME)
    batch, max_len, steps = case_inputs(case)
    r = ref[case]
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    _reset_routes()
    logits, cache, _ = model.prefill(params, _torch_batch(batch),
                                     max_len=max_len, attn_impl=attn_impl)
    np.testing.assert_allclose(logits.numpy(), r["logits"], **TOL["float32"])
    _check_tree(cache, r["cache"], "prefill")
    for j, st in enumerate(steps):
        lg, cache = model.decode_step(params, cache, _torch_batch(st),
                                      attn_impl=attn_impl)
        np.testing.assert_allclose(lg.numpy(), r["steps"][j],
                                   **TOL["float32"], err_msg=f"step {j}")
    _check_tree(cache, r["final_cache"], "final")
    n_super = cfg.num_layers // cfg.shared_attn_every
    route = "plain" if attn_impl == "auto" else "flash_ref"
    assert T.PREFILL_ROUTES == {k: n_super * (k == route)
                                for k in T.PREFILL_ROUTES}
    route = "plain" if attn_impl == "auto" else "paged_ref"
    assert T.DECODE_ROUTES == {k: n_super * len(steps) * (k == route)
                               for k in T.DECODE_ROUTES}


def test_window_and_ring_cache_lengths(ref):
    """The window case keeps W = 32 slots of a 40-token prompt; the ring
    case's cache is the window (max_len 48 > 32), and its first row
    reaches the window's end at the fifth decode step."""
    assert ref["window"]["cache"]["attn"]["k"].shape[2] == 32
    assert ref["ring"]["cache"]["attn"]["k"].shape[2] == 32
    _, _, steps = case_inputs("ring")
    assert [int(s["kv_len"].max()) >= 32 for s in steps] == \
        [False] * 4 + [True] * 4


def test_decode_from_the_reference_cache(ref):
    """``cache_from_numpy`` takes the reference's hybrid cache; decoding
    from it equals the reference's steps (fp32)."""
    cfg = get_reduced_config(NAME)
    _, _, steps = case_inputs("ragged")
    r = ref["ragged"]
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    cache = cache_from_numpy(cfg, r["cache"], "cpu",
                             compute_dtype=torch.float32)
    for j, st in enumerate(steps):
        lg, cache = model.decode_step(params, cache, _torch_batch(st),
                                      attn_impl="ref")
        np.testing.assert_allclose(lg.numpy(), r["steps"][j],
                                   **TOL["float32"], err_msg=f"step {j}")
    bad = dict(r["cache"], conv=r["cache"]["conv"][..., :-1])
    with pytest.raises(ValueError, match="conv"):
        cache_from_numpy(cfg, bad, "cpu", compute_dtype=torch.float32)


def test_ragged_rows_absorb_their_padding(ref):
    """As in the reference, prefill runs the recurrences over the whole
    padded S: a ragged row's conv state (the last W - 1 positions of the
    padded sequence) and SSM state differ from the same row prefilled
    alone at its length, while a full-length row's equal it.  The port
    computes the reference's function (held above) and keeps this."""
    cfg = get_reduced_config(NAME)
    batch, _, _ = case_inputs("ragged")
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    _, cache, _ = model.prefill(params, _torch_batch(batch))
    for b, n in enumerate(batch["prompt_lens"]):
        alone = {"tokens": torch.from_numpy(batch["tokens"][b:b + 1, :n])}
        _, own, _ = model.prefill(params, alone)
        for name in ("conv", "ssm"):
            same = torch.allclose(cache[name][:, :, b], own[name][:, :, 0],
                                  rtol=2e-5, atol=2e-5)
            assert same == (n == batch["tokens"].shape[1]), (name, b, n)


def test_window_prefill_past_the_window_on_kernel_routes(ref):
    """A prompt past the window (40 in 32) on the kernel routes: ``ref``
    runs flash's plain version with the window, once per application of
    the shared block, and equals the reference's prefill (logits and the
    ring cache, fp32 2e-5) and the plain route's; ``cuda`` routes a
    prompt past the published config's window to the kernel."""
    cfg = get_reduced_config(NAME)
    batch, max_len, _ = case_inputs("window")
    r = ref["window"]
    params = params_from_numpy(cfg, ref["params"], "cpu")
    model = build_model(cfg, compute_dtype=torch.float32)
    _reset_routes()
    logits, cache, _ = model.prefill(params, _torch_batch(batch),
                                     max_len=max_len, attn_impl="ref")
    n_super = cfg.num_layers // cfg.shared_attn_every
    assert T.PREFILL_ROUTES["flash_ref"] == n_super
    np.testing.assert_allclose(logits.numpy(), r["logits"], **TOL["float32"])
    _check_tree(cache, r["cache"], "prefill")
    plain, _, _ = model.prefill(params, _torch_batch(batch), max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), plain.numpy(),
                               **TOL["float32"])
    # the published config, past its window at its head dim: the kernel
    full = get_config(NAME)
    q = torch.zeros(1, full.sliding_window + 1, 1, full.resolved_head_dim)
    assert T.prefill_route(full, q, "cuda") == "flash"


def _to_torch(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["ragged", "ring"])
def test_zamba_matches_jax_bf16_per_hop(ref, case):
    """bf16 (this process's JAX computes in bf16) on the plain route, which
    rounds where the reference does, hop by hop: at the prefill and at each
    decode step, every application of the shared block and every mamba
    layer is handed the same bf16 input in both frameworks (the
    reference's output of the hop before) and its output held within 2e-2
    plus one bf16 ulp, each framework keeping its own caches and states;
    then the head on the same final hidden state.  A whole bf16 chain of
    six hops drifts further, by a bf16 ulp or two a hop, as ROADMAP.md
    section 3 records: it is held in fp32 above, and here only by its
    greedy tokens where the reference's top-2 margin is clear."""
    from repro.configs import get_reduced_config as j_get
    from repro.models import layers as JL
    from repro.models import mamba2 as JZ
    from repro_torch.models import layers as L

    assert JL.COMPUTE_DTYPE == jnp.bfloat16
    cfg, jcfg = get_reduced_config(NAME), j_get(NAME)
    batch, max_len, steps = case_inputs(case)
    jp = jax.tree.map(jnp.asarray, ref["params"])
    params = params_from_numpy(cfg, ref["params"], "cpu")
    dt = torch.bfloat16
    shared = Z._shared_params(params, dt)
    n_super, every = params["mamba"]["w_in"].shape[:2]

    def head(h_j, rows):
        jl = jnp.einsum("bd,dv->bv", JL.rms_norm(h_j, jp["final_ln"],
                                                 jcfg.norm_eps)[rows],
                        jp["lm_head"].astype(jnp.bfloat16))
        tl = T._logits(params, cfg, _to_torch(h_j)[rows])
        _close_bf16(tl, jl, "head")
        return tl, jl

    # prefill, hop by hop
    B, S = batch["tokens"].shape
    h_j = jnp.take(jp["embed"], jnp.asarray(batch["tokens"]), axis=0).astype(
        jnp.bfloat16)
    h0_j = h_j
    pos_j = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    pos_t = torch.arange(S)[None].expand(B, S)
    kv_j, kv_t, st_j, st_t = [], [], {}, {}
    for i in range(n_super):
        out_j, kv = JZ.shared_attn_block(h_j, h0_j, jp["shared_attn"], jcfg,
                                         pos_j, None)
        kv_j.append(kv)
        out_t, kv = Z.shared_attn_block(_to_torch(h_j), _to_torch(h0_j),
                                        shared, cfg, pos_t)
        kv_t.append(kv)
        _close_bf16(out_t, out_j, f"prefill shared {i}")
        h_j = out_j
        for j in range(every):
            lp = jax.tree.map(lambda a: a[i, j], jp["mamba"])
            out_j, st_j[i, j] = JZ.mamba_forward(h_j, lp, jcfg, None)
            out_t, st_t[i, j] = Z.mamba_forward(
                _to_torch(h_j), Z._mamba_params(params, i, j, dt), cfg)
            _close_bf16(out_t, out_j, f"prefill mamba {i}.{j}")
            h_j = out_j
    rows = np.arange(B), batch["prompt_lens"] - 1
    tl, jl = head(h_j, rows)
    clear = _tokens_agree(tl, jl)
    cache_j = JL.finalize_prefill_cache(
        jnp.stack([k for k, _ in kv_j]), jnp.stack([v for _, v in kv_j]),
        jcfg, max_len, seq_axis=2)
    cache_t = L.finalize_prefill_cache(
        torch.stack([k for k, _ in kv_t]), torch.stack([v for _, v in kv_t]),
        cfg, max_len, seq_axis=2)
    # decode, hop by hop
    for n, st in enumerate(steps):
        kv_len = st["kv_len"]
        h_j = jnp.take(jp["embed"], jnp.asarray(st["tokens"]), axis=0).astype(
            jnp.bfloat16)
        h0_j = h_j
        pos_j = jnp.asarray(kv_len)[:, None]
        pos_t = torch.from_numpy(kv_len).long()[:, None]
        plan = T.DecodeAttention.plan(cfg, _to_torch(h_j), "auto", cache_t,
                                      torch.from_numpy(kv_len))
        for i in range(n_super):
            out_j, cache_j = JZ.shared_attn_block(
                h_j, h0_j, jp["shared_attn"], jcfg, pos_j, None,
                cache=cache_j, kv_len=jnp.asarray(kv_len), layer_idx=i)
            out_t, _ = Z.shared_attn_block(
                _to_torch(h_j), _to_torch(h0_j), shared, cfg, pos_t,
                cache=cache_t, attn=plan, layer_idx=i, compute_dtype=dt)
            _close_bf16(out_t, out_j, f"step {n} shared {i}")
            h_j = out_j
            for j in range(every):
                lp = jax.tree.map(lambda a: a[i, j], jp["mamba"])
                out_j, st_j[i, j] = JZ.mamba_forward(
                    h_j, lp, jcfg, None, conv_state=st_j[i, j][0],
                    ssm_state=st_j[i, j][1])
                out_t, st_t[i, j] = Z.mamba_forward(
                    _to_torch(h_j), Z._mamba_params(params, i, j, dt), cfg,
                    conv_state=st_t[i, j][0], ssm_state=st_t[i, j][1])
                _close_bf16(out_t, out_j, f"step {n} mamba {i}.{j}")
                h_j = out_j
        tl, jl = head(h_j[:, 0], slice(None))
        clear += _tokens_agree(tl, jl)
    assert clear > 0
    # the whole chains: greedy tokens equal where the reference's margin is
    # clear
    model = build_model(cfg)
    jl_all, tl_all = [], []
    tl, tc, _ = model.prefill(params, _torch_batch(batch), max_len=max_len)
    jl, jc, _ = JZ.zamba_prefill(jp, jcfg, jax.tree.map(jnp.asarray, batch),
                                 max_len=max_len)
    tl_all.append(tl), jl_all.append(jl)
    for st in steps:
        tl, tc = model.decode_step(params, tc, _torch_batch(st))
        jl, jc = JZ.zamba_decode_step(jp, jcfg, jc,
                                      jax.tree.map(jnp.asarray, st))
        tl_all.append(tl), jl_all.append(jl)
    assert sum(_tokens_agree(t, j) for t, j in zip(tl_all, jl_all)) > 0
