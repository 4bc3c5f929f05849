"""The PyTorch port's stitching blocks (paper §4.3, Table 3), cross-size
equivalence (§4.1, Fig. 10) and block profiler (§6) — counterparts of
``tests/test_stitching.py`` and ``test_equivalence.py``'s cross-size test
on ``blockllm-demo`` -> ``blockllm-demo-large``, plus parity with the JAX
reference.

The reference's fp32 side runs in a subprocess (``REPRO_COMPUTE_DTYPE=
float32``) from numpy-seeded inputs; its ``train_stitching_block`` draws
its own initial ``w``, so there its init is replaced by the same numpy
``w`` the port starts from, and the reference's own loop (loss, Adam,
bias correction by the global step count) runs unchanged.  Tolerances:
hidden states fp32 2e-5; per-point losses 1e-4 relative after 60 steps a
point; similarities 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.equivalence import cross_size_equivalence
from repro_torch.core.stitching import (
    _hidden_at_layer,
    apply_stitch,
    make_stitch_block,
    stitched_head_similarity,
    train_stitching_block,
)
from repro_torch.core.zoo import BlockZoo
from repro_torch.models.model import build_model, params_from_numpy
from test_torch_model_api import jax_fp32_pickle

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

POINTS = [(1, 2), (2, 3)]
STEPS = 60

_JAX_STITCHING = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core import stitching as S
from repro.core.equivalence import cross_size_equivalence
from repro.models.model import build_model

as_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
cfg_a, cfg_b = get_config("blockllm-demo"), get_config("blockllm-demo-large")
ma, mb = build_model(cfg_a), build_model(cfg_b)
pa, pb = ma.init(jax.random.PRNGKey(0)), mb.init(jax.random.PRNGKey(1))
rng = np.random.RandomState(2)
tokens = rng.randint(0, cfg_a.vocab_size, (4, 32)).astype(np.int32)
w0 = (rng.standard_normal((cfg_a.d_model + 1, cfg_b.d_model))
      / np.sqrt(cfg_a.d_model + 1)).astype(np.float32)
probe = rng.randint(0, cfg_a.vocab_size, (2, 16)).astype(np.int32)
out = {{"pa": as_np(pa), "pb": as_np(pb), "tokens": tokens, "w0": w0,
       "probe": probe}}
out["h_a"] = as_np(S._hidden_at_layer(pa, cfg_a, jnp.asarray(tokens), 2))
out["h_b"] = as_np(S._hidden_at_layer(pb, cfg_b, jnp.asarray(tokens), 3))
# the reference's loop from the given w: its init returns w0
S.L.dense_init = lambda rng, shape, in_axis_size=None: jnp.asarray(w0)
w, losses = S.train_stitching_block(pa, cfg_a, pb, cfg_b, {points!r},
                                    jnp.asarray(tokens),
                                    steps_per_point={steps})
out["w"], out["losses"] = as_np(w), losses
out["sim"] = S.stitched_head_similarity(pa, cfg_a, pb, cfg_b, w, (2, 3),
                                        jnp.asarray(tokens))
out["sim0"] = S.stitched_head_similarity(pa, cfg_a, pb, cfg_b,
                                         jnp.asarray(w0), (2, 3),
                                         jnp.asarray(tokens))
out["eq"] = cross_size_equivalence(ma, pa, cfg_a, mb, pb, cfg_b,
                                   jnp.asarray(probe))
pickle.dump(out, open({out!r}, "wb"))
"""


@pytest.fixture(scope="module")
def ref():
    torch.set_num_threads(1)
    return jax_fp32_pickle(_JAX_STITCHING, points=POINTS, steps=STEPS)


@pytest.fixture(scope="module")
def fp32(ref):
    """The reference's trees in the port, fp32."""
    cfg_a, cfg_b = get_config("blockllm-demo"), get_config("blockllm-demo-large")
    return (cfg_a, params_from_numpy(cfg_a, ref["pa"], "cpu"),
            cfg_b, params_from_numpy(cfg_b, ref["pb"], "cpu"),
            torch.from_numpy(ref["tokens"]))


@pytest.fixture(scope="module")
def two_models():
    """The reference tests' setup in the port (bf16 compute, torch-drawn
    weights)."""
    torch.set_num_threads(1)
    cfg_a, cfg_b = get_config("blockllm-demo"), get_config("blockllm-demo-large")
    pa = build_model(cfg_a).init(torch.Generator().manual_seed(0))
    pb = build_model(cfg_b).init(torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg_a.vocab_size, (4, 32)).astype(np.int32))
    return cfg_a, pa, cfg_b, pb, tokens


F32 = dict(compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# parity with the reference, fp32
# ---------------------------------------------------------------------------


def test_hidden_at_layer_matches_jax_fp32(ref, fp32):
    cfg_a, pa, cfg_b, pb, tokens = fp32
    np.testing.assert_allclose(
        _hidden_at_layer(pa, cfg_a, tokens, 2, **F32).numpy(), ref["h_a"],
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _hidden_at_layer(pb, cfg_b, tokens, 3, **F32).numpy(), ref["h_b"],
        rtol=2e-5, atol=2e-5)


def test_train_stitching_losses_match_jax_fp32(ref, fp32):
    """The same initial w, the reference's Adam: per-point losses within
    1e-4 relative after 60 steps a point."""
    cfg_a, pa, cfg_b, pb, tokens = fp32
    w, losses = train_stitching_block(
        pa, cfg_a, pb, cfg_b, POINTS, tokens, steps_per_point=STEPS,
        w_init=torch.from_numpy(ref["w0"]), **F32)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    np.testing.assert_allclose(w.numpy(), ref["w"], rtol=1e-3, atol=1e-4)


def test_stitched_similarity_and_cross_size_match_jax_fp32(ref, fp32):
    cfg_a, pa, cfg_b, pb, tokens = fp32
    for w, want in ((ref["w"], ref["sim"]), (ref["w0"], ref["sim0"])):
        got = stitched_head_similarity(pa, cfg_a, pb, cfg_b,
                                       torch.from_numpy(w), (2, 3), tokens,
                                       **F32)
        assert got == pytest.approx(want, abs=1e-5)
    ma = build_model(cfg_a, torch.float32)
    mb = build_model(cfg_b, torch.float32)
    eq = cross_size_equivalence(ma, pa, cfg_a, mb, pb, cfg_b,
                                torch.from_numpy(ref["probe"]))
    assert eq == pytest.approx(ref["eq"], abs=1e-5)


def test_stitch_block_matches_jax(ref):
    """``add_stitch`` then ``apply_block`` against the reference's block on
    the same w (fp32 inputs)."""
    from repro.core.blocks import apply_block as j_apply
    from repro.core.stitching import make_stitch_block as j_make
    from repro_torch.core.blocks import apply_block

    w = ref["w"]
    h = np.random.RandomState(3).standard_normal((2, 8, w.shape[0] - 1)
                                                 ).astype(np.float32)
    zoo = BlockZoo()
    blk = make_stitch_block(torch.from_numpy(w), "a", "b", w.shape[0] - 1,
                            w.shape[1], 5.0)
    zoo.add_stitch(blk)
    jblk = j_make(jnp.asarray(w), "a", "b", w.shape[0] - 1, w.shape[1], 5.0)
    assert blk.id == jblk.id
    assert zoo.stitches == {(w.shape[0] - 1, w.shape[1]): blk.id}
    got = apply_block(zoo.blocks[blk.id], torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_apply(jblk, jnp.asarray(h))),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got.numpy(), apply_stitch(torch.from_numpy(w), torch.from_numpy(h),
                                  5.0).numpy(), rtol=0, atol=0)


def test_profile_block_record(ref):
    """One record per block: the reference's ``Block.bytes`` and a positive
    per-token time at each batch size."""
    from repro.core.zoo import BlockZoo as JZoo
    from repro_torch.bridge import to_torch

    cfg = get_config("blockllm-demo")
    jzoo, zoo = JZoo(), BlockZoo()
    jzoo.register_foundation("a", cfg, jax.tree.map(jnp.asarray, ref["pa"]))
    zoo.register_foundation("a", cfg, to_torch(ref["pa"], device="cpu"))
    blk = make_stitch_block(torch.from_numpy(ref["w"]), "a", "b", 256, 384,
                            5.0)
    zoo.add_stitch(blk)
    for bid in zoo.chains["a"].block_ids()[:2] + [blk.id]:
        rec = zoo.profile_block(bid, batch_sizes=(1, 4), seq_len=16)
        want = jzoo.blocks[bid].bytes if bid in jzoo.blocks else \
            4 * ref["w"].size
        assert rec.bytes == want == zoo.blocks[bid].bytes
        assert sorted(rec.compute_time_per_token) == [1, 4]
        assert all(t > 0 for t in rec.compute_time_per_token.values())
        assert zoo.profiles[bid] is rec


# ---------------------------------------------------------------------------
# the reference's tests, in the port (bf16 compute)
# ---------------------------------------------------------------------------


def test_train_stitch_reduces_loss(two_models):
    cfg_a, pa, cfg_b, pb, tokens = two_models
    w, losses = train_stitching_block(
        pa, cfg_a, pb, cfg_b, POINTS, tokens, steps_per_point=STEPS)
    assert w.shape == (cfg_a.d_model + 1, cfg_b.d_model)
    # loss must improve over an untrained stitch at the deepest point
    w0 = 0.02 * torch.randn(w.shape, generator=torch.Generator().manual_seed(9))
    h_a = _hidden_at_layer(pa, cfg_a, tokens, 2)
    h_b = _hidden_at_layer(pb, cfg_b, tokens, 3)

    def mse(w_):
        pred = apply_stitch(w_, h_a, 5.0)
        return float(torch.mean(torch.square(pred.float() - h_b.float())))

    assert mse(w) < 0.5 * mse(w0)


def test_stitched_head_similarity(two_models):
    """Table 3 analogue: stitched small->large model vs the large model."""
    cfg_a, pa, cfg_b, pb, tokens = two_models
    w, _ = train_stitching_block(pa, cfg_a, pb, cfg_b, [(2, 3)], tokens,
                                 steps_per_point=100)
    sim = stitched_head_similarity(pa, cfg_a, pb, cfg_b, w, (2, 3), tokens)
    assert 0.0 <= sim <= 1.0
    # must beat an untrained stitch
    w0 = 0.02 * torch.randn(w.shape, generator=torch.Generator().manual_seed(8))
    sim0 = stitched_head_similarity(pa, cfg_a, pb, cfg_b, w0, (2, 3), tokens)
    assert sim > sim0


def test_stitch_block_in_zoo(two_models):
    cfg_a, pa, cfg_b, pb, tokens = two_models
    from repro_torch.core.blocks import apply_block

    g = torch.Generator().manual_seed(3)
    w = 0.02 * torch.randn(cfg_a.d_model + 1, cfg_b.d_model, generator=g)
    blk = make_stitch_block(w, "a", "b", cfg_a.d_model, cfg_b.d_model, 4.0)
    zoo = BlockZoo()
    zoo.add_stitch(blk)
    assert (cfg_a.d_model, cfg_b.d_model) in zoo.stitches
    h = torch.randn(2, 8, cfg_a.d_model, generator=g)
    out = apply_block(blk, h)
    assert out.shape == (2, 8, cfg_b.d_model)


def test_cross_size_equivalence_runs(two_models):
    """Different-embedding-size probe (Fig. 10).  Random init models share a
    vocabulary; the metric must be finite and in [0, 1]."""
    cfg_a, pa, cfg_b, pb, _ = two_models
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg_a.vocab_size, (2, 16)).astype(np.int32))
    eq = cross_size_equivalence(build_model(cfg_a), pa, cfg_a,
                                build_model(cfg_b), pb, cfg_b, tokens)
    assert 0.0 <= eq <= 1.0
