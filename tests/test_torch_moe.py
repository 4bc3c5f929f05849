"""The PyTorch port's MoE family (mixtral-8x22b, dbrx-132b: ``models/moe.py``,
``models/moe_dispatch.py``) behind the Model API, against the JAX
reference at the reduced configs.

The reference's fp32 side runs in a subprocess with
``REPRO_COMPUTE_DTYPE=float32``: per config it draws the parameters once,
then for each expert route -- the dense expert scan, capacity dispatch at
``capacity_factor`` 1.25 (lossy: tokens dropped) and at E/k (lossless), and
the top-k decode gather -- runs ``moe_prefill`` on padded prompts and four
teacher-forced ``moe_decode_step``s; and mixtral's sliding window with a
prompt longer than the window (the ring buffer).  The port gets the trees
through ``params_from_numpy``.  Its bf16 side runs against this process's
JAX, which computes in bf16.

Tolerances: fp32 at rtol/atol 2e-5, on the plain route (``auto`` on the
CPU) and the kernels' plain versions (``ref``); fp32 routes no token at a
near tie at these seeds (the smallest top-k gap is reported and held above
1e-3, 50 times the logits' fp32 error).  bf16 per step as
``test_torch_model_api.py`` states (2e-2 plus one bf16 ulp at the row's
largest logit, greedy tokens equal at a top-2 margin over 0.1), on the
rows whose own token routed at a router-logit gap of at least
``ROUTE_EPS`` in every layer: under it two bf16 runs may take different
experts, and the row then differs by a whole expert, not by rounding.
Those rows are counted, and held to at most a quarter of all.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.moe_dispatch import dropped_fraction, moe_dispatch_mlp
from repro_torch.models.model import build_model, params_from_numpy
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

MOE = ("dbrx-132b", "mixtral-8x22b")
# route -> config fields (the lossless capacity factor E / k is filled in)
ROUTES = {"dense": {},
          "dispatch_lossy": {"moe_impl": "dispatch", "capacity_factor": 1.25},
          "dispatch_lossless": {"moe_impl": "dispatch"},
          "gather": {"moe_decode_gather": True}}
CASES = [f"{name}:{route}" for name in MOE for route in ROUTES] + [
    "mixtral-8x22b:window"]
# a router-logit gap (k-th against (k+1)-th) under which two bf16 runs may
# route a token differently: a few bf16 ulps of the logits (|logit| ~ 1-3)
ROUTE_EPS = 0.05
FP32_MIN_GAP = 1e-3


def case_config(case: str):
    name, route = case.split(":")
    cfg = get_reduced_config(name)
    fields = dict(ROUTES.get(route, {}))
    if route == "dispatch_lossless":
        fields["capacity_factor"] = cfg.num_experts / cfg.num_experts_per_tok
    return cfg.replace(**fields)


def case_inputs(case: str):
    """numpy inputs: (batch, max_len, decode batches).  The window case
    prefills 40 tokens into mixtral's window of 32 (a ring buffer of 32)."""
    name, route = case.split(":")
    cfg = get_reduced_config(name)
    if route == "window":
        B, S, plens, max_len = 2, 40, (40, 33), None
    else:
        B, S, plens, max_len = 4, 12, (12, 9, 7, 12), 16
    rng = np.random.RandomState(MOE.index(name) + 10 * (route == "window"))
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "prompt_lens": np.asarray(plens, np.int32)}
    steps = [{"tokens": rng.randint(0, cfg.vocab_size, (B, 1)).astype(
        np.int32), "kv_len": (np.asarray(plens) + j).astype(np.int32)}
        for j in range(4)]
    return batch, max_len, steps


_JAX_MOE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_moe import CASES, MOE, ROUTES, case_inputs
from repro.configs import get_reduced_config
from repro.models import moe as M
from repro.models.model import build_model

as_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
params = {{name: build_model(get_reduced_config(name)).init(
    jax.random.PRNGKey(i)) for i, name in enumerate(MOE)}}
out = {{"params": as_np(params)}}
for case in CASES:
    name, route = case.split(":")
    cfg = get_reduced_config(name)
    fields = dict(ROUTES.get(route, {{}}))
    if route == "dispatch_lossless":
        fields["capacity_factor"] = cfg.num_experts / cfg.num_experts_per_tok
    cfg = cfg.replace(**fields)
    batch, max_len, steps = case_inputs(case)
    p = params[name]
    logits, cache, _ = M.moe_prefill(p, cfg, jax.tree.map(jnp.asarray, batch),
                                     max_len=max_len)
    rec = {{"logits": as_np(logits), "cache": as_np(cache), "steps": []}}
    for st in steps:
        lg, cache = M.moe_decode_step(p, cfg, cache,
                                      jax.tree.map(jnp.asarray, st))
        rec["steps"].append(as_np(lg))
    rec["final_cache"] = as_np(cache)
    out[case] = rec
pickle.dump(out, open({out!r}, "wb"))
"""


@pytest.fixture(scope="module")
def ref():
    torch.set_num_threads(1)
    return jax_fp32_pickle(_JAX_MOE)


def _reset_routes():
    for d in (T.PREFILL_ROUTES, T.DECODE_ROUTES):
        for k in d:
            d[k] = 0


def unclear_rows(log, plens, n_layers: int) -> np.ndarray:
    """(steps + 1, B) bool from a run's ``moe.margin_log`` (prefill, then
    one entry a layer per decode step): whether the token whose logits
    make the row (the last prompt token, then each decode token) routed
    at a gap under ``ROUTE_EPS`` in some layer.  A token that takes another
    expert moves its own hidden state by a whole expert; the other tokens
    see it only through attention, spread over the sequence."""
    gaps = [np.stack([e["margin"].float().numpy() for e in
                      log[i:i + n_layers]]).min(axis=0)  # (B, S) or (B, 1)
            for i in range(0, len(log), n_layers)]
    last = np.asarray(plens) - 1
    own = [gaps[0][np.arange(len(last)), last]] + [g[:, 0] for g in gaps[1:]]
    return np.stack(own) < ROUTE_EPS


# ---------------------------------------------------------------------------
# configs, shapes, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MOE)
def test_specs_equal_the_reference(name):
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get
    from repro.models.model import build_model as j_build
    from repro_torch.configs import SHAPES

    mine, theirs = build_model(get_config(name)), j_build(j_get(name))

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
            {k: v.shape for k, v in want.items()}
    assert flat(mine.cache_specs(SHAPES["decode_32k"])) == \
        flat(theirs.cache_specs(J_SHAPES["decode_32k"]))


@pytest.mark.parametrize("name", MOE)
def test_stacked_init_draws_as_per_layer_init(name):
    """``init_moe`` fills its stacked tensors layer by layer in the order
    the per-layer init draws: equal to drawing each layer and stacking."""
    cfg = get_reduced_config(name).replace(qkv_bias=True)
    got = M.init_moe(cfg, torch.Generator().manual_seed(3), device="cpu")
    g = torch.Generator().manual_seed(3)
    embed = L.dense_init(g, (cfg.vocab_size, cfg.d_model),
                         in_axis_size=cfg.d_model)
    layers = [M.init_moe_layer(cfg, g) for _ in range(cfg.num_layers)]
    head = L.dense_init(g, (cfg.d_model, cfg.vocab_size))
    assert torch.equal(got["embed"], embed)
    assert torch.equal(got["lm_head"], head)
    assert sorted(got["layers"]) == sorted(layers[0])
    for k in layers[0]:
        assert torch.equal(got["layers"][k],
                           torch.stack([p[k] for p in layers])), k


# ---------------------------------------------------------------------------
# routing and dispatch, piece by piece
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MOE)
def test_router_weights_equal_jax(name):
    from repro.configs import get_reduced_config as j_get
    from repro.models import moe as JM

    cfg = get_reduced_config(name)
    rng = np.random.RandomState(20)
    h = rng.standard_normal((3, 7, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.num_experts))
              / np.sqrt(cfg.d_model)).astype(np.float32)
    want = np.asarray(JM.router_weights(jnp.asarray(h), jnp.asarray(router),
                                        j_get(name)))
    got = M.router_weights(torch.from_numpy(h), torch.from_numpy(router), cfg)
    # the same experts exactly; the weights within fp32 rounding (the two
    # frameworks' softmax differ by an ulp)
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])
    assert ((got > 0).sum(-1) == cfg.num_experts_per_tok).all()
    # both sort the selected experts descending
    logits = h @ router
    _, j_idx = jax.lax.top_k(jnp.asarray(logits), cfg.num_experts_per_tok)
    _, t_idx = torch.topk(torch.from_numpy(logits), cfg.num_experts_per_tok)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
def test_dispatch_and_dropped_fraction_equal_jax(cf):
    """``moe_dispatch_mlp`` in fp32 at 2e-5 and ``dropped_fraction``
    exactly, at capacities that drop many, some and no tokens."""
    from repro.configs import get_reduced_config as j_get
    from repro.models import moe as JM
    from repro.models.moe_dispatch import dropped_fraction as j_dropped
    from repro.models.moe_dispatch import moe_dispatch_mlp as j_dispatch

    cfg = get_reduced_config("dbrx-132b").replace(capacity_factor=cf)
    jcfg = j_get("dbrx-132b").replace(capacity_factor=cf)
    rng = np.random.RandomState(21)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    h = rng.standard_normal((2, 13, D)).astype(np.float32)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "e_gate": (0.2 * rng.standard_normal((E, D, F))).astype(np.float32),
         "e_up": (0.2 * rng.standard_normal((E, D, F))).astype(np.float32),
         "e_down": (0.2 * rng.standard_normal((E, F, D))).astype(np.float32)}
    jcomb = JM.router_weights(jnp.asarray(h), jnp.asarray(p["router"]), jcfg)
    comb = M.router_weights(torch.from_numpy(h),
                            torch.from_numpy(p["router"]), cfg)
    want = j_dispatch(jnp.asarray(h), jcomb,
                      {k: jnp.asarray(v) for k, v in p.items()}, jcfg, None)
    got = moe_dispatch_mlp(torch.from_numpy(h), comb,
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    frac = float(dropped_fraction(comb, cfg))
    assert frac == float(j_dropped(jcomb, jcfg))
    if cf == 0.5:  # 3 slots an expert for 13 tokens x 2 / 4 experts
        assert frac > 0
    if cf == 2.0:  # E / k: lossless
        assert frac == 0


def test_gather_sum_order_within_tolerance():
    """The gather route sums the k selected experts in top-k order (both
    frameworks sort descending); another order of the same fp32 sum stays
    within the fp32 tolerance."""
    cfg = get_reduced_config("dbrx-132b").replace(num_experts_per_tok=3)
    p = {k: v[0] for k, v in M.init_moe(
        cfg, torch.Generator().manual_seed(5), device="cpu")[
            "layers"].items()}
    h = torch.from_numpy(np.random.RandomState(22).standard_normal(
        (5, 1, cfg.d_model)).astype(np.float32))
    logits = M._router_logits(h, p["router"])[:, 0]
    top, idx = torch.topk(logits, cfg.num_experts_per_tok)
    w = torch.softmax(top, -1)
    y = torch.stack([torch.stack([M._expert(h[b, 0], p["e_gate"][e],
                                            p["e_up"][e], p["e_down"][e])
                                  for e in idx[b].tolist()])
                     for b in range(h.shape[0])])
    fwd = torch.einsum("bk,bkd->bd", w, y)
    rev = torch.einsum("bk,bkd->bd", w.flip(1), y.flip(1))
    np.testing.assert_allclose(fwd.numpy(), rev.numpy(), **TOL["float32"])
    np.testing.assert_allclose(M._decode_gather(h, p, cfg)[:, 0].numpy(),
                               fwd.numpy(), **TOL["float32"])


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------


FP32_RUNS = [(c, impl) for c in CASES for impl in ("auto", "ref")]


@pytest.mark.parametrize("case,attn_impl", FP32_RUNS)
def test_moe_matches_jax_fp32(ref, case, attn_impl):
    """fp32: prefill logits and cache, each teacher-forced decode step's
    logits and the final cache; the prefill and decode routes counted.
    The window case's prompt is longer than the window: it prefills with
    the window on ``attn_impl`` (flash's plain version takes it under
    ``ref``), then decodes its ring buffer (every row past the window: the
    ring's insert and the attend-only paged route under ``ref``)."""
    name = case.split(":")[0]
    cfg = case_config(case)
    batch, max_len, steps = case_inputs(case)
    r = ref[case]
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"][name], "cpu")
    _reset_routes()
    M.margin_log = []
    try:
        logits, cache, _ = model.prefill(params, _torch_batch(batch),
                                         max_len=max_len,
                                         attn_impl=attn_impl)
        np.testing.assert_allclose(logits.numpy(), r["logits"],
                                   **TOL["float32"])
        _check_cache(cache, r["cache"], cfg)
        for j, st in enumerate(steps):
            lg, cache = model.decode_step(params, cache, _torch_batch(st),
                                          attn_impl=attn_impl)
            np.testing.assert_allclose(lg.numpy(), r["steps"][j],
                                       **TOL["float32"], err_msg=f"step {j}")
        _check_cache(cache, r["final_cache"], cfg)
        gap = min(float(e["margin"].min()) for e in M.margin_log)
    finally:
        M.margin_log = None
    assert gap > FP32_MIN_GAP, gap
    n = cfg.num_layers
    assert T.PREFILL_ROUTES == {
        k: n * (k == ("plain" if attn_impl == "auto" else "flash_ref"))
        for k in T.PREFILL_ROUTES}
    route = "plain" if attn_impl == "auto" else "paged_ref"
    assert T.DECODE_ROUTES == {k: n * len(steps) * (k == route)
                               for k in T.DECODE_ROUTES}


def test_window_prefill_past_the_window_on_kernel_routes(ref):
    """mixtral's prompt of 40 tokens in a window of 32 on the kernel
    routes: ``ref`` runs flash's plain version with the window, once a
    layer, and equals the reference's prefill (logits and the ring cache,
    fp32 2e-5) and the plain route's; ``cuda`` routes a prompt past the
    published config's window to the kernel."""
    case = "mixtral-8x22b:window"
    cfg = case_config(case)
    batch, max_len, _ = case_inputs(case)
    r = ref[case]
    params = params_from_numpy(cfg, ref["params"]["mixtral-8x22b"], "cpu")
    model = build_model(cfg, compute_dtype=torch.float32)
    _reset_routes()
    logits, cache, _ = model.prefill(params, _torch_batch(batch),
                                     max_len=max_len, attn_impl="ref")
    assert T.PREFILL_ROUTES["flash_ref"] == cfg.num_layers
    np.testing.assert_allclose(logits.numpy(), r["logits"], **TOL["float32"])
    _check_cache(cache, r["cache"], cfg)
    plain, _, _ = model.prefill(params, _torch_batch(batch), max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), plain.numpy(),
                               **TOL["float32"])
    # the published config, past its window at its head dim: the kernel
    full = get_config("mixtral-8x22b")
    q = torch.zeros(1, full.sliding_window + 1, 1, full.resolved_head_dim)
    assert T.prefill_route(full, q, "cuda") == "flash"


def test_lossy_dispatch_drops_tokens_in_these_cases(ref):
    """The lossy cases do drop tokens (so they test dropping): capacity
    round(12 * 2 * 1.25 / 4) = 8 slots against up to 12 tokens."""
    for name in MOE:
        cfg = case_config(f"{name}:dispatch_lossy")
        batch, _, _ = case_inputs(f"{name}:dispatch_lossy")
        params = params_from_numpy(cfg, ref["params"][name], "cpu")
        p = T._layer_params(params, 0, torch.float32)
        h = T._embed_tokens(params, cfg, _torch_batch(batch), torch.float32)
        pos = T._positions(cfg, {}, *h.shape[:2], "cpu")
        x = T._attn_layer_full(h, p, cfg, pos)
        comb = M.router_weights(L.rms_norm(x, p["ln2"], cfg.norm_eps),
                                p["router"], cfg)
        assert float(dropped_fraction(comb, cfg)) > 0, name
        lossless = case_config(f"{name}:dispatch_lossless")
        assert float(dropped_fraction(comb, lossless)) == 0.0


@pytest.mark.parametrize("name", MOE)
def test_dispatch_lossless_and_gather_equal_the_dense_scan(ref, name):
    """Inside the port, fp32: lossless dispatch and the decode gather
    compute the dense scan's function (2e-5)."""
    r = ref[f"{name}:dense"]
    for route in ("dispatch_lossless", "gather"):
        np.testing.assert_allclose(ref[f"{name}:{route}"]["logits"],
                                   r["logits"], **TOL["float32"])
        for a, b in zip(ref[f"{name}:{route}"]["steps"], r["steps"]):
            np.testing.assert_allclose(a, b, **TOL["float32"])


@pytest.mark.parametrize("case", [f"{n}:{r}" for n in MOE
                                  for r in ("dense", "gather")])
def test_moe_matches_jax_bf16(ref, case):
    """bf16 (this process's JAX computes in bf16): logits per step within
    2e-2 plus one bf16 ulp and greedy tokens equal at a clear margin, on
    the rows routed at a clear gap; the others counted."""
    from repro.configs import get_reduced_config as j_get
    from repro.models import layers as JL
    from repro.models import moe as JM

    assert JL.COMPUTE_DTYPE == jnp.bfloat16
    name, route = case.split(":")
    cfg = case_config(case)
    jcfg = j_get(name).replace(**ROUTES[route])
    batch, max_len, steps = case_inputs(case)
    jparams = jax.tree.map(jnp.asarray, ref["params"][name])
    params = params_from_numpy(cfg, ref["params"][name], "cpu")
    model = build_model(cfg)
    M.margin_log = []
    try:
        got, want = [], []
        tl, tc, _ = model.prefill(params, _torch_batch(batch),
                                  max_len=max_len)
        jl, jc, _ = JM.moe_prefill(jparams, jcfg, jax.tree.map(jnp.asarray,
                                                               batch),
                                   max_len=max_len)
        got.append(tl), want.append(jl)
        for st in steps:
            tl, tc = model.decode_step(params, tc, _torch_batch(st))
            jl, jc = JM.moe_decode_step(jparams, jcfg, jc,
                                        jax.tree.map(jnp.asarray, st))
            got.append(tl), want.append(jl)
        unclear = unclear_rows(M.margin_log, batch["prompt_lens"],
                               cfg.num_layers)
    finally:
        M.margin_log = None
    held = 0
    assert unclear.sum() <= unclear.size // 4, unclear
    for j, (g, w) in enumerate(zip(got, want)):
        keep = ~unclear[j]
        w = np.asarray(w, np.float32)[keep]
        _close_bf16(g[torch.from_numpy(keep)], w, f"step {j}")
        held += _tokens_agree(g[torch.from_numpy(keep)], w)
    assert held > 0, unclear
