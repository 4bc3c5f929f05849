"""The port's block surrogates (paper §5.2, Table 4) against the JAX
reference's ``repro.core.surrogates``, on the demo zoo's parameters bridged
into both packages (``test_torch_blocks.jax_demo_trees``).

Structured pruning must keep the reference's channels and heads exactly —
same pruned tensors, same configs, same ``su-`` ids — since the serving
engine's speculative path and its cross-framework token test rest on
both packages drafting with the same surrogates.  Fidelity is held to
1e-6 on one fp32 probe; LoRA recovery, started from the reference's
initial ``A``, to the tolerance stated below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.surrogates import (
    _topk_mask_indices,
    build_surrogate,
    recover_with_lora,
    surrogate_fidelity,
    surrogate_speedup,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RATIOS = (0.25, 0.5, 0.75)
FIDELITY_TOL = 1e-6
# recover_a/recover_b after 80 momentum steps from the same initial A: the
# two frameworks' fp32 gradients differ in summation order, which the
# descent carries along.  Measured on the CPU: recover_a equal, recover_b
# (|b| ~ 3e-6 median, 1.5e-5 max) within 1.4e-11; 1e-9 absolute is ~1/2600
# of the median |b| and leaves 70x room
RECOVER_TOL = dict(rtol=1e-4, atol=1e-9)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's many small CPU ops: as fast
    alone, and under the suite's parallel workers the default threads
    oversubscribe the cores (the speculation tests ran ~20x slower in the
    whole suite than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def zoos():
    from test_torch_blocks import jax_demo_trees, jax_zoo, port_zoo

    trees = jax_demo_trees()
    return jax_zoo(*trees), port_zoo(*trees)


def _block_id(zoo, kind: str) -> str:
    """Layer 1 of the base chain ('layer'), or app-lora's split halves of
    it ('attention', 'ffn')."""
    app = "base" if kind == "layer" else "app-lora"
    for s in zoo.chains[app].steps:
        blk = zoo.blocks[s.block_id]
        if blk.kind == kind and blk.layer_idx == 1:
            return blk.id
    raise KeyError(kind)


def _probe(seed: int, d: int) -> np.ndarray:
    return (0.1 * np.random.RandomState(seed).standard_normal((2, 16, d))
            ).astype(np.float32)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("scores,keep", [
    ([1.0, 3.0, 3.0, 2.0, 3.0], 2),
    ([5.0, 5.0, 5.0, 5.0], 3),
    ([0.5, 0.1, 0.9, 0.9, 0.2, 0.9], 4),
])
def test_topk_indices_break_ties_as_jax(scores, keep):
    from repro.core.surrogates import _topk_mask_indices as jax_topk

    want = np.asarray(jax_topk(jnp.asarray(scores, jnp.float32), keep))
    got = _topk_mask_indices(torch.tensor(scores), keep).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prune_kv", [False, True])
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("kind", ["layer", "attention", "ffn"])
def test_build_surrogate_matches_jax(zoos, kind, ratio, prune_kv):
    """Same kept channels and heads (the pruned tensors are equal element
    for element), same config, same id and the same FLOP-ratio speedup."""
    from repro.core.surrogates import build_surrogate as jax_build
    from repro.core.surrogates import surrogate_speedup as jax_speedup

    jz, pz = zoos
    bid = _block_id(jz, kind)
    js = jax_build(jz.blocks[bid], ratio, prune_kv=prune_kv)
    ps = build_surrogate(pz.blocks[bid], ratio, prune_kv=prune_kv)
    assert ps.id == js.id and ps.id.startswith("su-")
    assert sorted(ps.params) == sorted(js.params)
    for k, v in js.params.items():
        np.testing.assert_array_equal(_np(ps.params[k]), _np(v), err_msg=k)
    for f in ("d_ff", "num_heads", "num_kv_heads", "head_dim"):
        assert getattr(ps.cfg, f) == getattr(js.cfg, f), f
    assert ps.kv_signature == js.kv_signature
    assert ps.meta == js.meta
    pruned_ffn = "w_gate" in ps.params
    pruned_heads = prune_kv and kind != "ffn"
    if pruned_ffn or pruned_heads:
        assert ps.n_params < pz.blocks[bid].n_params
    else:  # an attention block pruned FFN-only: nothing to prune
        assert ps.n_params == pz.blocks[bid].n_params
    assert (ps.cfg.d_ff < pz.blocks[bid].cfg.d_ff) == pruned_ffn
    if not pruned_heads:  # FFN-only: the attention tensors are shared
        for k in ("wq", "wk", "wv", "wo"):
            if k in ps.params:
                assert ps.params[k] is pz.blocks[bid].params[k]
        assert ps.kv_signature == pz.blocks[bid].kv_signature
    assert surrogate_speedup(pz.blocks[bid], ps) == pytest.approx(
        jax_speedup(jz.blocks[bid], js), rel=1e-12)


def test_prune_ratio_zero_keeps_every_channel(zoos):
    """prune_ratio=0 (the engine's forced-accept setting) keeps the FFN's
    tensors value for value: the surrogate computes what its parent does."""
    _, pz = zoos
    blk = pz.blocks[_block_id(pz, "layer")]
    sur = build_surrogate(blk, 0.0, prune_kv=False)
    for k, v in blk.params.items():
        assert torch.equal(sur.params[k], v), k
    assert sur.id == f"su-{blk.id.split('-', 1)[1]}"


@pytest.mark.parametrize("prune_kv", [False, True])
@pytest.mark.parametrize("ratio", [0.25, 0.75])
def test_fidelity_matches_jax(zoos, ratio, prune_kv):
    from repro.core.surrogates import build_surrogate as jax_build
    from repro.core.surrogates import surrogate_fidelity as jax_fidelity

    jz, pz = zoos
    bid = _block_id(jz, "layer")
    probe = _probe(1, jz.blocks[bid].d_in)
    want = jax_fidelity(jz.blocks[bid],
                        jax_build(jz.blocks[bid], ratio, prune_kv=prune_kv),
                        jnp.asarray(probe))
    got = surrogate_fidelity(pz.blocks[bid],
                             build_surrogate(pz.blocks[bid], ratio,
                                             prune_kv=prune_kv),
                             torch.from_numpy(probe))
    assert abs(got - want) <= FIDELITY_TOL
    assert 0.0 < got < 1.0


def test_fidelity_orders_by_prune_ratio(zoos):
    """Milder pruning -> higher output cosine (Table 4 trend)."""
    _, pz = zoos
    blk = pz.blocks[_block_id(pz, "layer")]
    probe = torch.from_numpy(_probe(2, blk.d_in))
    fid = [surrogate_fidelity(blk, build_surrogate(blk, r), probe)
           for r in RATIOS]
    assert fid[0] > fid[1] > fid[2] and fid[0] > 0.5


def test_recover_with_lora_matches_jax(zoos):
    """From the reference's initial A (its PRNGKey(0) draw), 80 momentum
    steps give the reference's recover_a/recover_b to RECOVER_TOL, the
    same id shape and a fidelity no worse than before."""
    from repro.core.surrogates import build_surrogate as jax_build
    from repro.core.surrogates import recover_with_lora as jax_recover

    jz, pz = zoos
    bid = _block_id(jz, "layer")
    jb, pb = jz.blocks[bid], pz.blocks[bid]
    probe = _probe(3, jb.d_in)
    j_rec = jax_recover(jb, jax_build(jb, 0.5), jnp.asarray(probe), steps=80)
    k1, _ = jax.random.split(jax.random.PRNGKey(0))
    a0 = np.asarray(0.01 * jax.random.normal(k1, (jb.d_in, 8), jnp.float32))
    sur = build_surrogate(pb, 0.5)
    p_rec = recover_with_lora(pb, sur, torch.from_numpy(probe), steps=80,
                              a_init=a0)
    for k in ("recover_a", "recover_b"):
        np.testing.assert_allclose(_np(p_rec.params[k]),
                                   _np(j_rec.params[k]), **RECOVER_TOL,
                                   err_msg=k)
    assert p_rec.meta == dict(sur.meta, recovered=True)
    assert p_rec.id.startswith("su-") and p_rec.id != sur.id
    t_probe = torch.from_numpy(probe)
    before = surrogate_fidelity(pb, sur, t_probe)
    after = surrogate_fidelity(pb, p_rec, t_probe)
    assert after >= before - 1e-3


def test_recover_with_lora_from_generator_improves_fidelity(zoos):
    """The port's own start (a seeded torch.Generator): the fit lowers the
    surrogate's error on its probe."""
    _, pz = zoos
    blk = pz.blocks[_block_id(pz, "layer")]
    probe = torch.from_numpy(_probe(4, blk.d_in))
    sur = build_surrogate(blk, 0.75)
    rec = recover_with_lora(blk, sur, probe, steps=80,
                            generator=torch.Generator().manual_seed(5))
    assert rec.params["recover_a"].shape == (blk.d_in, 8)
    assert rec.params["recover_b"].shape == (8, blk.d_in)
    assert surrogate_fidelity(blk, rec, probe) > \
        surrogate_fidelity(blk, sur, probe)


def test_surrogate_cache_eviction(zoos):
    """The zoo's surrogate cache is a bounded LRU keyed by (parent id,
    ratio, prune_kv): hits return the cached id, eviction removes the
    surrogate block from the zoo, and a re-request rebuilds it — as
    tests/test_spec_decode.py::test_surrogate_cache_eviction holds the
    reference's."""
    from test_torch_blocks import jax_demo_trees, port_zoo

    zoo = port_zoo(*jax_demo_trees())  # a zoo of its own: this test mutates
    layer_ids = [s.block_id for s in zoo.chains["base"].steps
                 if "w_gate" in zoo.blocks[s.block_id].params]
    assert len(layer_ids) >= 3
    assert zoo.surrogate_cache_max == 32 and not zoo._surrogate_cache
    zoo.surrogate_cache_max = 2
    a = zoo.surrogate_for(layer_ids[0], 0.25)
    assert zoo.surrogate_for(layer_ids[0], 0.25) == a  # cache hit
    assert zoo.surrogates[layer_ids[0]] == a
    b = zoo.surrogate_for(layer_ids[1], 0.25)
    c = zoo.surrogate_for(layer_ids[2], 0.25)  # evicts a (LRU)
    assert len(zoo._surrogate_cache) == 2
    assert a not in zoo.blocks  # evicted surrogates leave the zoo
    assert layer_ids[0] not in zoo.surrogates
    assert b in zoo.blocks and c in zoo.blocks
    # distinct ratios are distinct cache entries for the same parent
    d = zoo.surrogate_for(layer_ids[1], 0.5)
    assert d != b
    # rebuild after eviction is deterministic (same content hash -> id)
    assert zoo.surrogate_for(layer_ids[0], 0.25) == a
    assert a in zoo.blocks
    # FFN-only by default: the serving path's surrogates keep the KV layout
    assert zoo.blocks[a].kv_signature == zoo.blocks[layer_ids[0]].kv_signature
    assert zoo.blocks[a].cfg.num_heads == zoo.blocks[layer_ids[0]].cfg.num_heads


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_aliased_weights_share_one_cast(zoos, dtype):
    """A surrogate, a split attention/FFN block and their layer block read
    the very same cast tensor for every weight they alias; a weight the
    surrogate prunes (a new tensor) and a replaced one (a negated lm_head,
    as chip_smoke forces rejection) get their own.  In fp32 the cast is
    the tensor itself."""
    import dataclasses

    _, pz = zoos
    layer = pz.blocks[pz.chains["base"].steps[1].block_id]
    att_id, ffn_id = pz.split_layer_block(layer.id)
    sur = build_surrogate(layer, 0.25, prune_kv=False)  # the engine's kind
    p = layer.compute_params(dtype)
    sp = sur.compute_params(dtype)
    for k in ("wq", "wk", "wv", "wo"):
        assert sur.params[k] is layer.params[k]
        assert sp[k] is p[k] and pz.blocks[att_id].compute_params(dtype)[k] \
            is p[k], k
        assert p[k].dtype == dtype
    for k in ("w_gate", "w_up", "w_down"):
        assert pz.blocks[ffn_id].compute_params(dtype)[k] is p[k]
        assert sp[k] is not p[k] and sp[k].shape != p[k].shape
    assert (p["wq"] is layer.params["wq"]) == (dtype == torch.float32)
    head = pz.blocks[pz.chains["base"].steps[-1].block_id]
    neg = dataclasses.replace(
        head, id=head.id + "-neg",
        params=dict(head.params, lm_head=-head.params["lm_head"]),
        _compute={}, _scaling={})
    h, n = head.compute_params(dtype), neg.compute_params(dtype)
    assert n["final_ln"] is h["final_ln"]
    assert torch.equal(n["lm_head"], -h["lm_head"])
