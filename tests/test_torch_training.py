"""The PyTorch port's training (``Model.train_loss`` of every family,
``transformer.cross_entropy``, ``training/optimizer.py``,
``training/train_loop.py``, ``data/pipeline.py``) against the JAX
reference at the reduced configs.

The reference's fp32 side runs in one subprocess with
``REPRO_COMPUTE_DTYPE=float32``: per family it draws the parameters and
runs ``jax.value_and_grad`` of ``train_loss`` on one batch (labels partly
masked with -1); it runs ``cross_entropy`` unchunked and chunked,
``adamw_update`` with clipping active and without, and three jitted
``make_train_step`` steps at ``microbatches=2`` for each ``grad_compress``.
The port gets the trees through ``params_from_numpy``.

Tolerances: the loss within 2e-5 (relative), every leaf's gradient within
1e-4 in relative L2 norm (a weight's gradient sums over every position,
and fp32 sums in another order differ by more than one element's
rounding), ``adamw_update`` within 1e-6, the train steps' losses within
1e-5.  The pipeline's batches are bitwise the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model, params_from_numpy
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.training.train_loop import (
    TrainConfig,
    _compress,
    make_train_step,
    value_and_grad,
)
from repro_torch.tree import tree_flatten_with_paths, tree_leaves, tree_map
from test_torch_model_api import jax_fp32_pickle

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOSS_RTOL, GRAD_RTOL, OPT_TOL, STEP_TOL = 2e-5, 1e-4, 1e-6, 1e-5
B, S = 2, 40  # three query chunks of 16 (the last short), past a window of 32
# family case -> (config, fields replaced)
FAMILIES = {
    "dense": ("tinyllama-1.1b", {}),
    "vlm": ("qwen2-vl-7b", {}),
    "moe_dense": ("mixtral-8x22b", {}),
    "moe_dispatch": ("mixtral-8x22b", {"moe_impl": "dispatch"}),
    "encdec": ("seamless-m4t-medium", {}),
    "hybrid": ("zamba2-2.7b", {}),
    "ssm": ("xlstm-125m", {}),
}
COMPRESS = ("none", "bf16", "int8")
TRAIN_STEPS = 3


def family_config(case: str, get=get_reduced_config):
    name, fields = FAMILIES[case]
    return dataclasses.replace(get(name), **fields)


def family_batch(case: str, cfg) -> dict:
    """numpy inputs of a family case: tokens, labels with about a fifth
    masked (-1), and the family's extra inputs."""
    rng = np.random.RandomState(sorted(FAMILIES).index(case) + 60)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.rand(B, S) < 0.2] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.num_visual_tokens:
        batch["visual_embeds"] = (0.5 * rng.standard_normal(
            (B, cfg.num_visual_tokens, cfg.d_model))).astype(np.float32)
        batch["mrope_positions"] = rng.randint(
            0, S, (B, S, len(cfg.mrope_sections))).astype(np.int32)
    if cfg.family == "encdec":
        batch["frames"] = (0.1 * rng.standard_normal(
            (B, 24, cfg.d_model))).astype(np.float32)
    return batch


def ce_inputs():
    """(h (B, S, D), lm_head (D, V), labels (B, S) with -1s) for
    ``cross_entropy``: V = 256 in chunks of 64."""
    rng = np.random.RandomState(70)
    h = rng.standard_normal((B, S, 64)).astype(np.float32)
    w = (0.2 * rng.standard_normal((64, 256))).astype(np.float32)
    labels = rng.randint(0, 256, (B, S)).astype(np.int32)
    labels[rng.rand(B, S) < 0.3] = -1
    return h, w, labels


def opt_inputs(clip: bool):
    """(grads, opt_state, params) numpy trees for ``adamw_update`` at step
    3: gradients of global norm ~18 (clipped to 1) or ~0.2 (not)."""
    rng = np.random.RandomState(71 + clip)

    def tree(scale, positive=False):
        def leaf(shape):
            x = (scale * rng.standard_normal(shape)).astype(np.float32)
            return np.abs(x) if positive else x

        return {"wq": leaf((8, 4, 2)), "wk": leaf((8, 4, 2)),
                "b": leaf((4,)), "layers": {"w": leaf((3, 5))}}

    grads = tree(2.0 if clip else 0.02)
    state = {"step": np.int32(3), "m": tree(0.01), "v": tree(1e-3, True)}
    return grads, state, tree(1.0)


def step_data():
    cfg = get_reduced_config("tinyllama-1.1b")
    return cfg, DataConfig(vocab_size=cfg.vocab_size, global_batch=4,
                           seq_len=16)


_JAX_TRAINING = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_training import (COMPRESS, FAMILIES, TRAIN_STEPS, ce_inputs,
                                 family_batch, family_config, opt_inputs,
                                 step_data)
from repro.configs import get_reduced_config
from repro.data.pipeline import TokenPipeline
from repro.models.model import build_model
from repro.models.transformer import cross_entropy
from repro.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro.training.train_loop import TrainConfig, make_train_step

as_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
out = {{}}
for i, case in enumerate(sorted(FAMILIES)):
    cfg = family_config(case, get_reduced_config)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(i + 1))
    batch = jax.tree.map(jnp.asarray, family_batch(case, cfg))
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.train_loss(p, b)))
    loss, grads = fn(params, batch)
    out[case] = {{"params": as_np(params), "loss": float(loss),
                  "grads": as_np(grads)}}
h, w, labels = ce_inputs()
out["ce"] = {{c: float(cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                      jnp.asarray(labels), None, c))
              for c in (0, 64, 100)}}
for clip in (False, True):
    g, st, p = jax.tree.map(jnp.asarray, opt_inputs(clip))
    new_p, new_st, gn = adamw_update(g, st, p, AdamWConfig())
    out[("opt", clip)] = as_np((new_p, new_st, gn))
cfg, dc = step_data()
model = build_model(cfg)
params0 = model.init(jax.random.PRNGKey(9))
out["step_params"] = as_np(params0)
pipe = TokenPipeline(dc)
for how in COMPRESS:
    fn = jax.jit(make_train_step(model, TrainConfig(
        microbatches=2, grad_compress=how)))
    params, opt = params0, adamw_init(params0)
    losses = []
    for step in range(TRAIN_STEPS):
        b = jax.tree.map(jnp.asarray, pipe.batch_at(step))
        params, opt, m = fn(params, opt, b)
        losses.append(float(m["loss"]))
    out[("steps", how)] = {{"losses": losses, "params": as_np(params),
                            "grad_norm": float(m["grad_norm"])}}
pickle.dump(out, open({out!r}, "wb"))
"""


@pytest.fixture(scope="module")
def ref():
    torch.set_num_threads(1)
    return jax_fp32_pickle(_JAX_TRAINING)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    want = torch.from_numpy(np.asarray(want, np.float32))
    den = float(want.norm())
    num = float((got.detach().float() - want).norm())
    return num / den if den else num


# ---------------------------------------------------------------------------
# train_loss of every family against jax.value_and_grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_train_loss_and_grads_match_jax_fp32(ref, case):
    cfg = family_config(case)
    rec = ref[case]
    model = build_model(cfg, torch.float32)
    params = params_from_numpy(cfg, rec["params"], "cpu")
    loss, grads = value_and_grad(model, params,
                                 _torch_batch(family_batch(case, cfg)))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - rec["loss"]) <= LOSS_RTOL * abs(rec["loss"]), \
        (float(loss), rec["loss"])
    got, paths = tree_flatten_with_paths(grads)
    want = tree_leaves(rec["grads"])
    assert len(got) == len(want)
    worst = {p: _rel_l2(g, w) for g, w, p in zip(got, want, paths)}
    bad = {p: e for p, e in worst.items() if not e <= GRAD_RTOL}
    assert not bad, bad
    for g, p in zip(got, tree_leaves(params)):
        assert g.shape == p.shape and g.dtype == p.dtype


@pytest.mark.parametrize("chunk", (0, 64, 100))
def test_cross_entropy_routes_match_jax(ref, chunk):
    """The unchunked route, the streaming logsumexp over chunks of 64, and
    a chunk that does not divide V (the unchunked route), with masked
    labels, against the reference; the routes agree with one another."""
    h, w, labels = (torch.from_numpy(x) for x in ce_inputs())
    got = T.cross_entropy(h, w, labels, chunk)
    want = ref["ce"][chunk]
    assert abs(float(got) - want) <= LOSS_RTOL * abs(want), (float(got), want)
    whole = T.cross_entropy(h, w, labels, 0)
    assert abs(float(got) - float(whole)) <= 1e-6 * abs(float(whole))


def test_cross_entropy_chunked_gradient_equals_unchunked():
    h, w, labels = (torch.from_numpy(x) for x in ce_inputs())
    grads = []
    for chunk in (0, 64):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        T.cross_entropy(hh, ww, labels, chunk).backward()
        grads.append((hh.grad, ww.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_cross_entropy_masks_and_divides_by_at_least_one():
    h, w, labels = (torch.from_numpy(x) for x in ce_inputs())
    none = torch.full_like(labels, -1)
    assert float(T.cross_entropy(h, w, none)) == 0.0
    one = none.clone()
    one[0, 3] = 7
    logits = (h[0, 3] @ w).double()
    want = float(torch.logsumexp(logits, 0) - logits[7])
    assert abs(float(T.cross_entropy(h, w, one)) - want) < 1e-5


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _np_tree(x):
    from repro_torch.bridge import to_torch

    return to_torch(x, device="cpu")


@pytest.mark.parametrize("clip", (False, True), ids=("no_clip", "clip"))
def test_adamw_update_matches_jax(ref, clip):
    g, st, p = opt_inputs(clip)
    st = {"step": torch.tensor(int(st["step"]), dtype=torch.int32),
          "m": _np_tree(st["m"]), "v": _np_tree(st["v"])}
    new_p, new_st, gn = adamw_update(_np_tree(g), st, _np_tree(p),
                                     AdamWConfig())
    want_p, want_st, want_gn = ref[("opt", clip)]
    assert (float(gn) > 1.0) == clip
    assert abs(float(gn) - float(want_gn)) <= OPT_TOL * float(want_gn)
    assert int(new_st["step"]) == int(want_st["step"]) == 4
    assert new_st["step"].dtype == torch.int32
    for got, want in ((new_p, want_p), (new_st["m"], want_st["m"]),
                      (new_st["v"], want_st["v"])):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b, rtol=OPT_TOL,
                                       atol=OPT_TOL)


def test_adamw_update_is_functional():
    g, st, p = opt_inputs(True)
    params, grads = _np_tree(p), _np_tree(g)
    state = adamw_init(params)
    before = [t.clone() for t in tree_leaves((params, state))]
    new_p, new_st, _ = adamw_update(grads, state, params, AdamWConfig())
    for a, b in zip(before, tree_leaves((params, state))):
        assert torch.equal(a, b)
    assert int(new_st["step"]) == 1 and int(state["step"]) == 0
    assert list(new_p) == list(params)  # the caller's key order


def test_global_norm_sums_in_jax_flatten_order():
    tree = {"b": torch.tensor([3.0]), "a": [torch.tensor([4.0])]}
    assert float(global_norm(tree)) == 5.0
    assert [float(x) for x in tree_leaves(tree)] == [4.0, 3.0]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", COMPRESS)
def test_train_steps_match_jax(ref, how):
    """Three steps at ``microbatches=2``: the losses within 1e-5 of JAX's
    (the parameters move by ~lr a step, where a gradient near 0 may flip
    sign with rounding, so they are not held elementwise)."""
    cfg, dc = step_data()
    model = build_model(cfg, torch.float32)
    params = params_from_numpy(cfg, ref["step_params"], "cpu")
    opt = adamw_init(params)
    fn = make_train_step(model, TrainConfig(microbatches=2,
                                            grad_compress=how))
    pipe = TokenPipeline(dc)
    losses = []
    for step in range(TRAIN_STEPS):
        params, opt, m = fn(params, opt, _torch_batch(pipe.batch_at(step)))
        losses.append(float(m["loss"]))
    want = ref[("steps", how)]
    np.testing.assert_allclose(losses, want["losses"], rtol=STEP_TOL)
    assert int(opt["step"]) == TRAIN_STEPS
    assert abs(float(m["grad_norm"]) - want["grad_norm"]) <= \
        1e-3 * want["grad_norm"]
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))


def test_microbatches_average_the_grads():
    """``microbatches=2`` of a batch whose halves are the same rows gives
    the one-microbatch step's loss and parameters."""
    cfg, dc = step_data()
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    half = _torch_batch(TokenPipeline(dc).batch_at(0))
    half = {k: v[:2] for k, v in half.items()}
    doubled = {k: torch.cat([v, v]) for k, v in half.items()}
    p1, _, m1 = make_train_step(model, TrainConfig())(
        params, adamw_init(params), half)
    p2, _, m2 = make_train_step(model, TrainConfig(microbatches=2))(
        params, adamw_init(params), doubled)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-6
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_compress_int8_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -126.5])
    got = _compress({"x": x}, "int8")["x"]
    scale = (127.0 + 1e-12) / 127.0
    assert torch.equal(got, torch.tensor([127.0, 0.0, 2.0, 2.0, -0.0,
                                          -126.0]) * scale)
    assert torch.equal(_compress({"x": x}, "bf16")["x"],
                       x.to(torch.bfloat16).float())
    with pytest.raises(ValueError):
        _compress({"x": x}, "fp8")


# ---------------------------------------------------------------------------
# routes, casts and the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ("cuda", "ref"))
def test_train_loss_refuses_a_kernel_route(impl):
    cfg = get_reduced_config("tinyllama-1.1b")
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(family_batch("dense", cfg))
    with pytest.raises(NotImplementedError, match="no backward"):
        model.train_loss(params, batch, attn_impl=impl)
    with pytest.raises(ValueError):
        model.train_loss(params, batch, attn_impl="flash")


def test_train_loss_counts_each_layer_once_on_the_plain_route():
    """A step counts ``plain`` once per layer a forward, though each
    checkpointed layer runs its forward again in backward; no kernel
    route is counted."""
    cfg = get_reduced_config("seamless-m4t-medium")
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    for k in T.PREFILL_ROUTES:
        T.PREFILL_ROUTES[k] = 0
    value_and_grad(model, params, _torch_batch(family_batch("encdec", cfg)))
    n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
    assert T.PREFILL_ROUTES == {"flash": 0, "flash_ref": 0,
                                "plain": n_enc + n_dec, "cross_plain": n_dec}


def test_train_does_not_mark_or_cache_the_callers_params():
    cfg = get_reduced_config("tinyllama-1.1b")
    model = build_model(cfg)  # bf16 compute
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    value_and_grad(model, params, _torch_batch(family_batch("dense", cfg)))
    for t in tree_leaves(params):
        assert not t.requires_grad
        assert t not in L._CASTS


@pytest.mark.parametrize("update", ("functional", "in_place"))
def test_prefill_after_a_step_reads_the_updated_weights(update):
    """A bf16 prefill (its casts cached) then a train step: a prefill of
    the updated parameters equals one of a fresh copy of them, whether the
    step returned new tensors or they were written into the old ones."""
    cfg = get_reduced_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(family_batch("dense", cfg))
    prompt = {"tokens": batch["tokens"]}
    before, _, _ = model.prefill(params, prompt)
    new, _, _ = make_train_step(model, TrainConfig(
        opt=AdamWConfig(lr=1e-2)))(params, adamw_init(params), batch)
    if update == "in_place":
        for old, t in zip(tree_leaves(params), tree_leaves(new)):
            old.copy_(t)
        new = params
    fresh = tree_map(torch.clone, new)
    got, _, _ = model.prefill(new, prompt)
    want, _, _ = model.prefill(fresh, prompt)
    assert torch.equal(got, want)
    assert not torch.equal(got, before)


def test_pipeline_batches_are_the_references():
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import TokenPipeline as JTokenPipeline

    for kw in ({"vocab_size": 256, "global_batch": 4, "seq_len": 16},
               {"vocab_size": 32000, "global_batch": 8, "seq_len": 33,
                "seed": 5, "ngram": 3, "noise": 0.3}):
        for hosts in ((0, 1), (1, 2)):
            mine = TokenPipeline(DataConfig(**kw), *hosts)
            theirs = JTokenPipeline(JDataConfig(**kw), *hosts)
            for step in (0, 1, 7, 1000):
                a, b = mine.batch_at(step), theirs.batch_at(step)
                assert sorted(a) == sorted(b) == ["labels", "tokens"]
                for k in a:
                    assert a[k].dtype == b[k].dtype == np.int32
                    assert np.array_equal(a[k], b[k])
            it = iter(mine)
            assert np.array_equal(next(it)["tokens"],
                                  mine.batch_at(0)["tokens"])


def test_a_leaf_the_loss_does_not_read_gets_a_zero_gradient():
    """As ``jax.value_and_grad`` gives: an extra leaf in the tree (here a
    LoRA-style leaf beside the model's) has a zero gradient."""
    from repro_torch.models.model import Model

    cfg = get_reduced_config("tinyllama-1.1b")
    inner = build_model(cfg, torch.float32)
    model = Model(cfg, {"train_loss": lambda p, c, b, **kw:
                        inner.train_loss(p["model"], b)}, torch.float32)
    params = {"model": inner.init(torch.Generator().manual_seed(0), "cpu"),
              "unused": torch.ones(3)}
    loss, grads = value_and_grad(model, params,
                                 _torch_batch(family_batch("dense", cfg)))
    assert torch.equal(grads["unused"], torch.zeros(3))
    assert float(grads["model"]["lm_head"].abs().sum()) > 0
