"""The PyTorch port's Model API for the dense family (``build_model``,
``prefill``/``decode_step``, the dense KV cache) against the JAX reference.

The reference's fp32 side runs in a subprocess with
``REPRO_COMPUTE_DTYPE=float32`` (the JAX package reads its compute dtype
once, at import); it draws each config's parameters (qkv biases made
nonzero), runs ``dense_prefill`` on padded prompts and then teacher-forced
``dense_decode_step``s, and hands everything back as numpy.  The port gets
the same trees through ``params_from_numpy``.  Its bf16 side runs in this
process, whose JAX computes in bf16.

Tolerances: fp32 at rtol/atol 2e-5 (``tests/test_kernels.py``); bf16 per
step at 2e-2 plus one bf16 ulp at the row's largest logit magnitude (one
rounding at magnitude 2-4 is 0.03125, and a small logit inherits it from
hidden states of that size), with greedy tokens equal where the reference's
top-2 margin exceeds 0.1; int8 cache codes equal code for code, except a
code one off where the port's own x/scale lies within 1e-6 of a half,
counted and bounded (no code differs at these inputs: the nearest x/scale
is 3e-5 from a half).
"""
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import (
    get_config,
    get_reduced_config,
    list_configs,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import (
    build_model,
    cache_from_numpy,
    params_from_numpy,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
CLEAR_MARGIN = 0.1
HALF_WINDOW = 1e-6  # |x/scale - (n + 0.5)| below which a code may differ
MAX_CODE_FLIPS = 1e-3  # of all codes
DENSE = ("tinyllama-1.1b", "qwen1.5-32b", "qwen2-72b", "stablelm-12b",
         "qwen2-vl-7b", "blockllm-demo")

# case -> (config, fields replaced, B, S, prompt_lens, max_len, kv_len per
# decode step (None: prompt_lens + j), decode steps)
CASES = {
    **{name: (name, {}, 2, 12, (12, 7), 16, None, 4) for name in DENSE},
    # the ring buffer: 20 tokens into a window of 8, then 6 decodes
    "window": ("tinyllama-1.1b", {"sliding_window": 8}, 2, 20, (20, 20),
               None, None, 6),
    # a cache of S = 12: row 0 writes at S - 1, then at S and S + 1
    # (dropped); row 1 stays inside
    "overflow": ("tinyllama-1.1b", {}, 2, 10, (10, 8), 12,
                 ((11, 8), (12, 10), (13, 11)), 3),
}


def case_inputs(case: str):
    """numpy inputs of a case: (cfg fields, batch, max_len, decode batches)."""
    name, repl, B, S, plens, max_len, kv_sched, n_dec = CASES[case]
    cfg = get_reduced_config(name).replace(**repl)
    rng = np.random.RandomState(sorted(CASES).index(case))
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "prompt_lens": np.asarray(plens, np.int32)}
    if cfg.num_visual_tokens:
        batch["visual_embeds"] = (0.5 * rng.standard_normal(
            (B, cfg.num_visual_tokens, cfg.d_model))).astype(np.float32)
        batch["mrope_positions"] = rng.randint(
            0, S, (B, S, len(cfg.mrope_sections))).astype(np.int32)
    steps = []
    for j in range(n_dec):
        kv = (np.asarray(plens) + j if kv_sched is None
              else np.asarray(kv_sched[j]))
        steps.append({"tokens": rng.randint(0, cfg.vocab_size, (B, 1))
                      .astype(np.int32), "kv_len": kv.astype(np.int32)})
    return cfg, batch, max_len, steps


_JAX_MODEL_API = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_model_api import CASES, case_inputs
from repro.configs import get_reduced_config
from repro.core.blocks import Block, block_decode, block_prefill
from repro.models import transformer as T
from repro.models.model import build_model

as_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
out = {{}}
for i, case in enumerate(sorted(CASES)):
    cfg, batch, max_len, steps = case_inputs(case)
    jcfg = get_reduced_config(CASES[case][0]).replace(**CASES[case][1])
    params = build_model(jcfg).init(jax.random.PRNGKey(i))
    if jcfg.qkv_bias:  # the init's biases are zero
        rng = np.random.RandomState(100 + i)
        for b in ("bq", "bk", "bv"):
            params["layers"][b] = jnp.asarray(0.3 * rng.standard_normal(
                params["layers"][b].shape).astype(np.float32))
    jb = jax.tree.map(jnp.asarray, batch)
    logits, cache, plens = T.dense_prefill(params, jcfg, jb, max_len=max_len)
    rec = {{"params": as_np(params), "logits": as_np(logits),
           "cache": as_np(cache), "prompt_lens": as_np(plens), "steps": []}}
    for st in steps:
        lg, cache = T.dense_decode_step(params, jcfg, cache,
                                        jax.tree.map(jnp.asarray, st))
        rec["steps"].append(as_np(lg))
    rec["final_cache"] = as_np(cache)
    # one layer block, prefill then decode over its dense cache
    if case in ("tinyllama-1.1b", "qwen1.5-32b", "window"):
        lp = jax.tree.map(lambda x: x[0], params["layers"])
        blk = Block(id="b", kind="layer", model="m", layer_idx=0,
                    d_in=jcfg.d_model, d_out=jcfg.d_model, params=lp,
                    cfg=jcfg)
        x = np.random.RandomState(7).standard_normal(
            (2, batch["tokens"].shape[1], jcfg.d_model)).astype(np.float32)
        y, bc = block_prefill(blk, jnp.asarray(x), max_len=max_len)
        ys, kv = [], batch["prompt_lens"]
        for j in range(3):
            xd = np.random.RandomState(8 + j).standard_normal(
                (2, 1, jcfg.d_model)).astype(np.float32)
            yd, bc = block_decode(blk, jnp.asarray(xd), bc, jnp.asarray(kv + j))
            ys.append(as_np(yd))
        rec["block"] = {{"x": x, "prefill": as_np(y), "decode": ys,
                        "cache": as_np(bc)}}
    out[case] = rec
pickle.dump(out, open({out!r}, "wb"))
"""


def jax_fp32_pickle(script: str, timeout: int = 600, **fmt):
    """Run ``script`` (formatted with ``tests``, ``out`` and ``fmt``) where
    the JAX package computes in fp32, and return what it pickled to
    ``out``."""
    env = dict(os.environ, REPRO_COMPUTE_DTYPE="float32", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "out.pkl")
        code = script.format(tests=str(ROOT / "tests"), out=out, **fmt)
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=timeout)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return pickle.loads(Path(out).read_bytes())


@pytest.fixture(scope="module")
def ref():
    torch.set_num_threads(1)
    return jax_fp32_pickle(_JAX_MODEL_API)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each |x| (2^(e - 7) for |x| in [2^e, 2^(e+1)))."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(1.0, e - 8).astype(np.float32)


def _close_bf16(got, want, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    # one ulp at the row's logit magnitude: a logit's rounding error
    # comes from hidden states of that size, whatever its own value
    mag = np.abs(want).max(axis=-1, keepdims=True)
    bound = 2e-2 + 2e-2 * np.abs(want) + _ulp(mag)
    bad = np.abs(got - want) > bound
    assert not bad.any(), (what, float(np.abs(got - want).max()),
                           int(bad.sum()))


def _tokens_agree(got_logits, want_logits):
    got = np.asarray(got_logits.float()).argmax(-1)
    want_logits = np.asarray(want_logits, np.float32)
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > CLEAR_MARGIN
    np.testing.assert_array_equal(got[clear], want_logits.argmax(-1)[clear])
    return int(clear.sum())


def _check_cache(got: dict, want: dict, cfg, raw=None):
    """fp32 caches at 2e-5; int8 codes equal except near-half flips (by
    ``raw``: the port's own pre-quantization K/V per entry)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        if g.dtype != torch.int8:
            np.testing.assert_allclose(g.float().numpy(), np.asarray(
                w, np.float32), **TOL["float32"], err_msg=name)
            continue
        diff = g.numpy().astype(np.int32) != w.astype(np.int32)
        assert np.abs(g.numpy().astype(np.int32) - w)[diff].max(
            initial=0) <= 1, name
        assert diff.sum() <= MAX_CODE_FLIPS * diff.size, (name, diff.sum())
        if diff.any():
            x = raw[name] / got[f"{name}_scale"].numpy()
            frac = np.abs(np.abs(x) - np.floor(np.abs(x)) - 0.5)
            assert (frac[diff] < HALF_WINDOW).all(), (name, frac[diff].max())


def _raw_prefill_kv(params, cfg, batch, max_len):
    """The port's fp32 K/V of every layer before quantization, laid out as
    the cache (for locating int8 code flips)."""
    h = T._embed_tokens(params, cfg, batch, torch.float32)
    B, S = batch["tokens"].shape
    pos = T._positions(cfg, batch, B, S, h.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        p = T._layer_params(params, i, torch.float32)
        h, (k, v) = T._attn_layer_full(h, p, cfg, pos, return_kv=True)
        h = T._mlp_layer(h, p, cfg)
        pad = (0, 0, 0, 0, 0, (max_len or S) - S)
        ks.append(torch.nn.functional.pad(k, pad))
        vs.append(torch.nn.functional.pad(v, pad))
    return {"k": torch.stack(ks).numpy(), "v": torch.stack(vs).numpy()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_list_configs_and_fields_equal_the_reference():
    import dataclasses

    from repro.configs import get_config as j_get
    from repro.configs import get_reduced_config as j_get_reduced
    from repro.configs import list_configs as j_list

    assert list_configs() == j_list()
    assert len(list_configs()) == 12
    for name in list_configs():
        for mine, theirs in ((get_config(name), j_get(name)),
                             (get_reduced_config(name), j_get_reduced(name))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), name
            assert mine.resolved_head_dim == theirs.resolved_head_dim


def test_shapes_and_applicable_shapes_equal_the_reference():
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import applicable_shapes as j_app
    from repro.configs import get_config as j_get
    from repro_torch.configs import SHAPES, applicable_shapes

    assert {k: vars(v) for k, v in SHAPES.items()} == \
        {k: vars(v) for k, v in J_SHAPES.items()}
    for name in list_configs():
        assert [s.name for s in applicable_shapes(get_config(name))] == \
            [s.name for s in j_app(j_get(name))]


@pytest.mark.parametrize("name", DENSE + (
    "blockllm-demo-large", "mixtral-8x22b", "dbrx-132b",
    "seamless-m4t-medium", "zamba2-2.7b", "xlstm-125m"))
def test_param_count_equals_the_reference_at_full_size(name):
    from repro.configs import get_config as j_get

    cfg = get_config(name)
    assert cfg.param_count() == j_get(name).param_count()
    assert cfg.active_param_count() == j_get(name).active_param_count()
    assert (cfg.active_param_count() < cfg.param_count()) == \
        (cfg.family == "moe")
    shapes = build_model(cfg).param_shapes()
    assert shapes["embed"].device.type == "meta"


@pytest.mark.parametrize("name", list_configs())
def test_build_model_builds_every_registered_config(name):
    """Every registered config builds, at its published size, with meta
    shapes equal to the reference's parameter tree (the leaves' paths,
    shapes and dtypes)."""
    from repro.configs import get_config as j_get
    from repro.models.model import build_model as j_build

    cfg = get_config(name)
    model = build_model(cfg)
    assert model.cfg is cfg
    ref_leaves = jax.tree_util.tree_leaves_with_path(
        j_build(j_get(name)).param_shapes())
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in ref_leaves}
    got_leaves = jax.tree_util.tree_leaves_with_path(
        model.param_shapes(), is_leaf=lambda x: isinstance(x, torch.Tensor))
    got = {jax.tree_util.keystr(p): (tuple(x.shape),
                                     str(x.dtype).split(".")[-1])
           for p, x in got_leaves}
    assert got == want


def test_training_raises_until_ported():
    """Training is ported: ``train_loss`` gives a finite loss on the plain
    route, and raises only for a kernel route, whose kernel has no
    backward (none is ported, as the reference has none)."""
    cfg = get_reduced_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens}
    assert torch.isfinite(model.train_loss(params, batch))
    with pytest.raises(NotImplementedError, match="no backward"):
        model.train_loss(params, batch, attn_impl="cuda")


def test_specs_are_meta_shapes():
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get
    from repro.models.model import build_model as j_build
    from repro_torch.configs import SHAPES

    for name in ("qwen1.5-32b", "qwen2-vl-7b", "tinyllama-1.1b"):
        mine, theirs = build_model(get_config(name)), j_build(j_get(name))
        for shape in ("prefill_32k", "decode_32k", "train_4k"):
            got = mine.batch_specs(SHAPES[shape])
            want = theirs.batch_specs(J_SHAPES[shape])
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: v.shape for k, v in want.items()}
            assert all(v.device.type == "meta" for v in got.values())
        got = mine.cache_specs(SHAPES["decode_32k"])
        want = theirs.cache_specs(J_SHAPES["decode_32k"])
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}


def test_params_from_numpy_checks_the_tree(ref):
    cfg, *_ = case_inputs("tinyllama-1.1b")
    tree = ref["tinyllama-1.1b"]["params"]
    params = params_from_numpy(cfg, tree, "cpu")
    assert params["layers"]["wq"].dtype == torch.float32
    bad = dict(tree, layers=dict(tree["layers"]))
    bad["layers"]["wq"] = bad["layers"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(cfg, {k: v for k, v in tree.items()
                                if k != "lm_head"}, "cpu")


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------


FP32_RUNS = [(c, impl) for c in sorted(CASES) for impl in ("auto", "ref")]


@pytest.mark.parametrize("case,attn_impl", FP32_RUNS)
def test_prefill_and_decode_match_jax_fp32(ref, case, attn_impl):
    """fp32: prefill logits and cache, then each decode step's logits and
    the final cache, on the plain route (``auto`` on the CPU) and on the
    kernels' plain versions (``ref``: flash's, and paged's over the cache's
    one-page-per-sequence view).  The window case's prompt (20 tokens) is
    longer than its window (8): it prefills with the window on
    ``attn_impl`` like the others, then decodes its ring buffer."""
    cfg, batch, max_len, steps = case_inputs(case)
    r = ref[case]
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, r["params"], "cpu")
    tb = _torch_batch(batch)
    logits, cache, plens = model.prefill(params, tb, max_len=max_len,
                                         attn_impl=attn_impl)
    np.testing.assert_allclose(logits.numpy(), r["logits"], **TOL["float32"])
    np.testing.assert_array_equal(plens.numpy(), r["prompt_lens"])
    raw = (_raw_prefill_kv(params, cfg, tb, max_len)
           if cfg.kv_cache_dtype == "int8" else None)
    _check_cache(cache, r["cache"], cfg, raw)
    if cfg.kv_cache_dtype == "int8":  # decode from the reference's codes
        cache = cache_from_numpy(cfg, r["cache"], "cpu",
                                 compute_dtype=torch.float32)
    for key in T.DECODE_ROUTES:
        T.DECODE_ROUTES[key] = 0
    for j, st in enumerate(steps):
        lg, cache = model.decode_step(params, cache, _torch_batch(st),
                                      attn_impl=attn_impl)
        np.testing.assert_allclose(lg.numpy(), r["steps"][j],
                                   **TOL["float32"], err_msg=f"step {j}")
    route = ("int8" if cfg.kv_cache_dtype == "int8" else
             "plain" if attn_impl == "auto" else "paged_ref")
    assert T.DECODE_ROUTES == {k: cfg.num_layers * len(steps) * (k == route)
                               for k in T.DECODE_ROUTES}
    if cfg.kv_cache_dtype != "int8":
        _check_cache(cache, r["final_cache"], cfg)


@pytest.mark.parametrize("case", sorted(set(CASES) - {"overflow"}))
def test_prefill_and_decode_match_jax_bf16(ref, case):
    """bf16 (this process's JAX computes in bf16): logits per step within
    2e-2 plus one bf16 ulp, greedy tokens equal where the margin is clear."""
    from repro.configs import get_reduced_config as j_get_reduced
    from repro.models import layers as JL
    from repro.models import transformer as JT

    assert JL.COMPUTE_DTYPE == jnp.bfloat16
    cfg, batch, max_len, steps = case_inputs(case)
    r = ref[case]
    jcfg = j_get_reduced(CASES[case][0]).replace(**CASES[case][1])
    jparams = jax.tree.map(jnp.asarray, r["params"])
    jl, jc, _ = JT.dense_prefill(jparams, jcfg, jax.tree.map(jnp.asarray,
                                                             batch),
                                 max_len=max_len)
    model = build_model(cfg)
    params = params_from_numpy(cfg, r["params"], "cpu")
    tl, tc, _ = model.prefill(params, _torch_batch(batch), max_len=max_len)
    assert tl.dtype == torch.bfloat16
    _close_bf16(tl, jl, "prefill")
    clear = _tokens_agree(tl, jl)
    for j, st in enumerate(steps):
        jl, jc = JT.dense_decode_step(jparams, jcfg, jc,
                                      jax.tree.map(jnp.asarray, st))
        tl, tc = model.decode_step(params, tc, _torch_batch(st))
        _close_bf16(tl, jl, f"step {j}")
        clear += _tokens_agree(tl, jl)
    assert clear > 0


def test_overflow_write_is_dropped(ref):
    """At kv_len >= S the write is dropped and the token attends over the
    S cached positions, on the plain route and the paged ref route."""
    r = ref["overflow"]
    cfg, batch, max_len, steps = case_inputs("overflow")
    final = r["final_cache"]["k"]
    # row 0 wrote at S - 1 = 11 only; slot 11 holds step 0's token
    assert final.shape[2] == max_len
    assert not np.array_equal(final[:, 0, 11], r["cache"]["k"][:, 0, 11])
    for attn_impl in ("auto", "ref"):
        model = build_model(cfg, compute_dtype=torch.float32)
        params = params_from_numpy(cfg, r["params"], "cpu")
        _, cache, _ = model.prefill(params, _torch_batch(batch),
                                    max_len=max_len)
        after_first = None
        for j, st in enumerate(steps):
            _, cache = model.decode_step(params, cache, _torch_batch(st),
                                         attn_impl=attn_impl)
            if j == 0:
                after_first = cache["k"][:, 0].clone()
        # the dropped writes left row 0 as step 0 left it
        assert torch.equal(cache["k"][:, 0], after_first)


# ---------------------------------------------------------------------------
# one block's dense cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["tinyllama-1.1b", "qwen1.5-32b", "window"])
def test_block_prefill_and_decode_match_jax_fp32(ref, case):
    from repro_torch.core.blocks import Block, block_decode, block_prefill

    cfg, batch, max_len, _ = case_inputs(case)
    r = ref[case]
    rb = r["block"]
    lp = {k: v[0] for k, v in params_from_numpy(
        cfg, r["params"], "cpu")["layers"].items()}
    blk = Block(id="b", kind="layer", model="m", layer_idx=0,
                d_in=cfg.d_model, d_out=cfg.d_model, params=lp, cfg=cfg)
    y, cache = block_prefill(blk, torch.from_numpy(rb["x"]), max_len=max_len,
                             compute_dtype=torch.float32)
    np.testing.assert_allclose(y.numpy(), rb["prefill"], **TOL["float32"])
    kv = torch.from_numpy(batch["prompt_lens"])
    for j in range(3):
        xd = np.random.RandomState(8 + j).standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)
        yd, cache = block_decode(blk, torch.from_numpy(xd), cache, kv + j,
                                 compute_dtype=torch.float32)
        np.testing.assert_allclose(yd.numpy(), rb["decode"][j],
                                   **TOL["float32"], err_msg=f"step {j}")
    if cfg.kv_cache_dtype == "int8":
        for name in ("k", "v"):
            diff = cache[name].numpy() != rb["cache"][name]
            assert diff.sum() <= MAX_CODE_FLIPS * diff.size
    else:
        _check_cache(cache, rb["cache"], cfg)


# ---------------------------------------------------------------------------
# the chain of blocks against the Model API, inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_matches_model_prefill(dtype):
    """``run_chain``'s last position against ``dense_prefill`` on one set
    of weights: fp32 at 2e-5; bf16 within one bf16 ulp of the logit."""
    from repro_torch.core.blocks import run_chain
    from repro_torch.core.zoo import BlockZoo

    torch.set_num_threads(1)
    cfg = get_config("blockllm-demo")
    model = build_model(cfg, compute_dtype=getattr(torch, dtype))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    zoo = BlockZoo()
    chain = zoo.register_foundation("base", cfg, params)
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    got = run_chain(zoo, chain, tokens,
                    compute_dtype=getattr(torch, dtype))[:, -1]
    want, _, _ = model.prefill(params, {"tokens": tokens})
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   **TOL["float32"])
    else:
        w = want.float().numpy()
        assert (np.abs(got.float().numpy() - w) <= _ulp(w)).all()
        assert torch.equal(got.float().argmax(-1), want.float().argmax(-1))


# ---------------------------------------------------------------------------
# layers: M-RoPE, int8 KV, decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections", [(4, 2, 2), (2, 2, 2), (6, 4, 2)])
def test_mrope_matches_jax_fp32(sections):
    """M-RoPE sections summing to, short of and past head_dim / 2 = 8."""
    from repro.models import layers as JL

    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.randint(0, 50, (2, 5, 3)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, sections)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                       sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_quantize_kv_matches_jax():
    from repro.models import layers as JL

    rng = np.random.RandomState(4)
    x = (3 * rng.standard_normal((2, 7, 3, 16))).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero row: scale floor 1e-6 / 127
    jq, js = JL.quantize_kv(jnp.asarray(x))
    tq, ts = L.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        L.dequantize_kv(tq, ts).numpy(),
        np.asarray(JL.dequantize_kv(jq, js)))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("kv_chunk", [0, 8])
def test_decode_attention_matches_jax_fp32(window, kv_chunk):
    from repro.models import layers as JL

    rng = np.random.RandomState(5)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, 32, 2, 16)).astype(np.float32)
            for _ in range(2))
    lens = np.asarray([1, 17, 32], np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lens), window=window,
                               kv_chunk=kv_chunk)
    got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(lens),
                             window=window, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_kernel_gaps_raise_not_implemented():
    """Under the kernel route: head dims 80 (zamba2's shared attention) and
    160 (stablelm-12b) route to the kernels; a head dim the kernels still
    lack (96) has no kernel; a prompt longer than a sliding window runs
    flash with the window; the route is chosen before any launch."""
    stablelm = get_config("stablelm-12b")
    zamba = get_config("zamba2-2.7b")
    assert (stablelm.resolved_head_dim, zamba.resolved_head_dim) == (160, 80)
    x = torch.zeros(1, 1, 1)
    for cfg in (stablelm, zamba):
        hd = cfg.resolved_head_dim
        assert T.decode_route(cfg, x, "cuda") == "paged"
        assert T.prefill_route(cfg, torch.zeros(1, 4, 2, hd),
                               "cuda") == "flash"
    missing = stablelm.replace(head_dim=96)
    with pytest.raises(NotImplementedError, match="head dim 96"):
        T.decode_route(missing, x, "cuda")
    q = torch.zeros(1, 4, 2, 96)
    with pytest.raises(NotImplementedError, match="head dim 96"):
        T.prefill_attention(q, q, q, missing, "cuda")
    windowed = get_config("tinyllama-1.1b").replace(sliding_window=64)
    q = torch.zeros(1, 65, 2, 64)  # S = 65 > the window of 64
    assert T.prefill_route(windowed, q, "cuda") == "flash"
    assert T.prefill_route(windowed, q, "ref") == "flash_ref"
    assert T.prefill_route(windowed, q[:, :64], "cuda") == "flash"
    assert T.prefill_route(windowed, q[:, :2], "ref") == "flash_ref"
    assert T.prefill_route(windowed, q, "auto") == "plain"  # a CPU tensor
    # the config picks the plain route for int8, whatever attn_impl says;
    # a window's ring buffer decodes on the paged kernel
    assert T.decode_route(get_config("qwen1.5-32b"), x, "cuda") == "int8"
    assert T.decode_route(windowed, x, "cuda") == "paged"
    assert T.decode_route(windowed, x, "auto") == "plain"  # a CPU tensor
    assert T.decode_route(get_config("qwen2-72b"), x, "cuda") == "paged"
    assert T.decode_route(get_config("qwen2-72b"), x, "ref") == "paged_ref"
    # the reference's plain code only by device: auto on a CPU tensor
    assert T.decode_route(get_config("qwen2-72b"), x, "auto") == "plain"
    with pytest.raises(ValueError, match="attn_impl 'plain'"):
        T.decode_route(get_config("qwen2-72b"), x, "plain")


def test_window_decode_on_paged_ref_equals_the_plain_ring():
    """A sliding window's ring of S = 8 slots on the kernels' plain
    versions (``ref``: the fused step while every row is inside the ring,
    then the ring's insert and attend-only paged attention once a row has
    reached S) equals the reference's plain ring buffer (``auto`` on the
    CPU) across the wrap, fp32 2e-5, and writes the same cache."""
    cfg = get_reduced_config("tinyllama-1.1b").replace(sliding_window=8)
    model = build_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(13)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 6))
                              .astype(np.int32))
    lens = torch.tensor([6, 4], dtype=torch.int32)
    batch = {"tokens": tokens, "prompt_lens": lens}
    caches = {impl: model.prefill(params, batch, max_len=16,
                                  attn_impl=impl)[1]
              for impl in ("auto", "ref")}
    assert caches["ref"]["k"].shape[2] == 8
    for j in range(6):  # row 0 reaches S at the third step, row 1 at the 5th
        st = {"tokens": torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (2, 1)).astype(np.int32)), "kv_len": lens + j}
        want, _ = model.decode_step(params, caches["auto"], st,
                                    attn_impl="auto")
        got, _ = model.decode_step(params, caches["ref"], st,
                                   attn_impl="ref")
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   **TOL["float32"], err_msg=f"step {j}")
    for name in ("k", "v"):
        np.testing.assert_allclose(caches["ref"][name].numpy(),
                                   caches["auto"][name].numpy(),
                                   **TOL["float32"])


@pytest.mark.parametrize("S", [1, 7, 8, 9, 20, 33])
def test_window_prefill_on_flash_equals_the_windowed_reference(S):
    """Inside the window (8) and past it, the ``ref`` route (flash's plain
    version, handed ``cfg.sliding_window``) equals
    ``layers.causal_attention(window=8)``, fp32 2e-5."""
    cfg = get_reduced_config("tinyllama-1.1b").replace(sliding_window=8)
    rng = np.random.RandomState(12)
    q = torch.from_numpy(rng.standard_normal((2, S, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, S, 2, 16))
                             .astype(np.float32)) for _ in range(2))
    want = L.causal_attention(q, k, v, chunk=cfg.attn_chunk, window=8)
    got = T.prefill_attention(q, k, v, cfg, "ref")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_mlps_match_jax_fp32():
    from repro.models import layers as JL

    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wg, wu = (0.2 * rng.standard_normal((16, 24))).astype(np.float32), \
        (0.2 * rng.standard_normal((16, 24))).astype(np.float32)
    wd = (0.2 * rng.standard_normal((24, 16))).astype(np.float32)
    b_in = rng.standard_normal(24).astype(np.float32)
    b_out = rng.standard_normal(16).astype(np.float32)
    j, t = (lambda *a: [jnp.asarray(v) for v in a]), \
        (lambda *a: [torch.from_numpy(v) for v in a])
    np.testing.assert_allclose(L.swiglu(*t(x, wg, wu, wd)).numpy(),
                               np.asarray(JL.swiglu(*j(x, wg, wu, wd))),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        L.gelu_mlp(*t(x, wg, b_in, wd, b_out)).numpy(),
        np.asarray(JL.gelu_mlp(*j(x, wg, b_in, wd, b_out))),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window,kv_dtype", [(0, "bf16"), (6, "bf16"),
                                             (0, "int8")])
def test_cache_helpers_match_jax(window, kv_dtype):
    """finalize_prefill_cache (padding, or the last W tokens at their ring
    slots), then cache_insert of 3 tokens (ring wrap, or past the end:
    dropped), fp32 values and int8 codes exact."""
    from repro.configs import get_reduced_config as j_get_reduced
    from repro.models import layers as JL

    fields = dict(sliding_window=window, kv_cache_dtype=kv_dtype)
    cfg = get_reduced_config("tinyllama-1.1b").replace(**fields)
    jcfg = j_get_reduced("tinyllama-1.1b").replace(**fields)
    rng = np.random.RandomState(9)
    k, v = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
            for _ in range(2))
    kn, vn = (rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
              for _ in range(2))
    pos = np.asarray([9, 10], np.int32)  # row 1 runs past a cache of 11
    want = JL.finalize_prefill_cache(jnp.asarray(k), jnp.asarray(v), jcfg,
                                     max_len=11)
    want = JL.cache_insert(want, jnp.asarray(kn), jnp.asarray(vn),
                           jnp.asarray(pos), jcfg)
    # the reference keeps a bf16 cache in its compute dtype (bf16 in this
    # process), the port in its K/V's dtype
    dt = torch.float32 if kv_dtype == "int8" else torch.bfloat16
    got = L.finalize_prefill_cache(torch.from_numpy(k).to(dt),
                                   torch.from_numpy(v).to(dt), cfg,
                                   max_len=11)
    got = L.cache_insert(got, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.from_numpy(pos), cfg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(w, np.float32), err_msg=name)
    shapes = T.init_cache_shape(cfg, 2, 11)
    from repro.models.transformer import init_cache_shape as j_shape

    assert {n: tuple(t.shape) for n, t in shapes.items()} == \
        {n: t.shape for n, t in j_shape(jcfg, 2, 11).items()}
