"""The PyTorch port's block zoo and block hops against the JAX reference.

Parameters come from the JAX demo zoo's recipe (``repro.serving.demo``,
seed 0) with the LoRA ``b_q``/``b_v`` made nonzero (the recipe starts them
at zero, which would make app-lora numerically the base model); both sides
register the same numpy trees.  Hops are compared in fp32 (rtol/atol 2e-5)
and in bf16 (2e-2), the tolerances of ``tests/test_kernels.py``; whole
chains in fp32 (2e-5) and in bf16 as the section on chains below says, with
greedy tokens equal wherever the reference's top-2 logit margin is clear.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SEED = 0
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
CLEAR_MARGIN = 0.1  # top-2 logit gap above which greedy tokens must agree


def jax_demo_trees(seed: int = SEED):
    """numpy trees of ``repro.serving.demo.build_demo_zoo``'s recipe:
    (base, ft, {"lora": [per-layer dicts]}), LoRA B matrices nonzero."""
    from repro.configs import get_config
    from repro.core import peft
    from repro.models.model import build_model

    cfg = get_config("blockllm-demo")
    params = build_model(cfg).init(jax.random.PRNGKey(seed))
    noisy = jax.tree.map(
        lambda x: x + 0.15 * jnp.std(x) * jax.random.normal(
            jax.random.PRNGKey(seed + 1), x.shape, x.dtype),
        jax.tree.map(lambda x: x[1], params["layers"]))
    ft = dict(params)
    ft["layers"] = jax.tree.map(lambda full, rep: full.at[1].set(rep),
                                params["layers"], noisy)
    lora = jax.device_get(peft.create_lora(cfg, jax.random.PRNGKey(seed + 2)))
    rng = np.random.RandomState(seed + 100)
    for layer in lora:
        for k in ("b_q", "b_v"):
            layer[k] = (0.05 * rng.standard_normal(layer[k].shape)
                        ).astype(np.float32)
    as_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731
    return as_np(params), as_np(ft), {"lora": [as_np(t) for t in lora]}


def jax_fp32_json(script: str, trees, timeout: int = 600):
    """Run ``script`` in a subprocess where the JAX package computes in
    fp32 (it reads its compute dtype once, at import), with ``TREES`` bound
    to ``trees`` (``jax_demo_trees()``'s value, handed over in a file so
    the subprocess does not draw them again), and return the JSON value of
    its last output line; the script can import this module's helpers
    (``from test_torch_blocks import ...``)."""
    import json
    import os
    import pickle
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, REPRO_COMPUTE_DTYPE="float32", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           str(root / "tests")]))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trees.pkl"
        path.write_bytes(pickle.dumps(trees))
        head = f"import pickle\nTREES = pickle.loads(open({str(path)!r}, 'rb').read())\n"
        proc = subprocess.run([sys.executable, "-c", head + script], env=env,
                              capture_output=True, text=True,
                              timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def jax_zoo(base, ft, pefts):
    from repro.configs import get_config
    from repro.core.zoo import BlockZoo

    cfg = get_config("blockllm-demo")
    zoo = BlockZoo()
    zoo.register_foundation("base", cfg, jax.tree.map(jnp.asarray, base))
    zoo.register_fpft("vicuna", cfg, jax.tree.map(jnp.asarray, ft), "base")
    for kind, trees in pefts.items():
        zoo.register_peft(f"app-{kind}", cfg, "base", kind,
                          [jax.tree.map(jnp.asarray, t) for t in trees])
    return zoo


def port_zoo(base, ft, pefts):
    from repro_torch.configs import get_config
    from repro_torch.serving.demo import zoo_from_params

    return zoo_from_params(get_config("blockllm-demo"), base, ft, pefts,
                           device="cpu")


@pytest.fixture(scope="module")
def zoos():
    trees = jax_demo_trees()
    return jax_zoo(*trees), port_zoo(*trees)


def _steps(zoo, app):
    return [(zoo.blocks[s.block_id],
             tuple(zoo.blocks[a] for a in s.adapter_ids))
            for s in zoo.chains[app].steps]


def _j(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _t(x, dtype):
    return to_torch(np.asarray(x, np.float32), device="cpu").to(
        getattr(torch, dtype))


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), **TOL[dtype], err_msg=what)


def _assert_tokens_agree(got, want_logits):
    """Greedy tokens equal wherever the reference's top-2 gap is clear."""
    want_logits = np.asarray(want_logits, np.float32)
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > CLEAR_MARGIN
    want = want_logits.argmax(-1)
    np.testing.assert_array_equal(np.asarray(got)[clear], want[clear])
    assert clear.any()


# ---------------------------------------------------------------------------
# zoo: ids, chains, equivalence edges
# ---------------------------------------------------------------------------


def test_zoo_block_ids_chains_and_edges_match(zoos):
    jz, pz = zoos
    assert set(pz.blocks) == set(jz.blocks)
    assert set(pz.chains) == set(jz.chains) == {"base", "vicuna", "app-lora"}
    for app, chain in jz.chains.items():
        assert [(s.block_id, tuple(s.adapter_ids)) for s in chain.steps] == \
            [(s.block_id, tuple(s.adapter_ids))
             for s in pz.chains[app].steps], app
    assert set(pz.equivalences) == set(jz.equivalences)
    assert len(pz.equivalences) == 2  # vicuna's layer 1 <-> base layer 1
    for key, score in jz.equivalences.items():
        assert pz.equivalences[key] == pytest.approx(score, abs=1e-12)
    for bid, blk in jz.blocks.items():
        assert pz.blocks[bid].kind == blk.kind
        assert pz.blocks[bid].kv_signature == blk.kv_signature
    assert pz.zoo_bytes() == jz.zoo_bytes()
    assert pz.per_model_bytes() == jz.per_model_bytes()


def test_seed0_foundation_block_id():
    """The unmodified JAX demo zoo at seed 0 names base layer 0
    ``la-cd406050c544934d``; the port hashes its bridged params the same."""
    from repro_torch.core.blocks import tree_hash

    base, _, _ = jax_demo_trees()
    layer0 = {k: v[0] for k, v in base["layers"].items()}
    port_layer0 = to_torch(layer0, device="cpu")
    assert f"la-{tree_hash(port_layer0)}" == "la-cd406050c544934d"
    assert tree_hash(layer0) == tree_hash(port_layer0)


# ---------------------------------------------------------------------------
# per-hop parity
# ---------------------------------------------------------------------------

# (app, chain step index): embed, layer, attention+LoRA, ffn, lm_head,
# and vicuna's divergent layer 1
HOPS = [("base", 0), ("base", 2), ("app-lora", 3), ("app-lora", 4),
        ("base", 5), ("vicuna", 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("app,idx", HOPS)
def test_apply_block_matches_jax(zoos, app, idx, dtype):
    from repro.core.blocks import apply_block as j_apply
    from repro_torch.core.blocks import apply_block as t_apply

    jz, pz = zoos
    (jb, ja), (tb, ta) = _steps(jz, app)[idx], _steps(pz, app)[idx]
    rng = np.random.RandomState(idx)
    if jb.kind == "embed":
        x = rng.randint(0, jb.cfg.vocab_size, size=(2, 9)).astype(np.int32)
        from repro.models import layers as JL

        want = j_apply(jb, jnp.asarray(x))
        got = t_apply(tb, torch.from_numpy(x),
                      compute_dtype=getattr(torch, str(JL.COMPUTE_DTYPE)))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        return
    x = rng.standard_normal((2, 9, jb.d_in)).astype(np.float32)
    want = j_apply(jb, _j(x, dtype), adapters=ja)
    got = t_apply(tb, _t(x, dtype), adapters=ta)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("app,idx", [("base", 2), ("app-lora", 3)])
def test_block_prefill_raw_matches_jax(zoos, app, idx, dtype):
    from repro.core.blocks import block_prefill_raw as j_prefill
    from repro_torch.core.blocks import block_prefill_raw as t_prefill

    jz, pz = zoos
    (jb, ja), (tb, ta) = _steps(jz, app)[idx], _steps(pz, app)[idx]
    x = np.random.RandomState(7).standard_normal(
        (2, 11, jb.d_in)).astype(np.float32)
    want = j_prefill(jb, _j(x, dtype), adapters=ja)
    got = t_prefill(tb, _t(x, dtype), adapters=ta)
    for g, w, what in zip(got, want, ("out", "k_r", "v")):
        _close(g, w, dtype, what)


def _pool_inputs(cfg, B=3, page=16, n=4, seed=3):
    """Random page slabs, shuffled disjoint page tables padded with trash
    page 0, ragged kv lengths (including a page boundary)."""
    rng = np.random.RandomState(seed)
    KVH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    P = 1 + B * n
    k = rng.standard_normal((P, page, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, page, KVH, hd)).astype(np.float32)
    tables = (rng.permutation(B * n) + 1).reshape(B, n).astype(np.int32)
    kv_len = np.asarray([15, 16, 37][:B], np.int32)
    tables[0, 1:] = 0  # row 0 owns one page: pad with the trash page
    return k, v, tables, kv_len


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("app,idx", [("base", 2), ("app-lora", 3)])
def test_block_decode_paged_matches_jax(zoos, app, idx, dtype):
    from repro.core.blocks import block_decode_paged as j_decode
    from repro_torch.core.blocks import block_decode_paged as t_decode

    jz, pz = zoos
    (jb, ja), (tb, ta) = _steps(jz, app)[idx], _steps(pz, app)[idx]
    k, v, tables, kv_len = _pool_inputs(jb.cfg)
    x = np.random.RandomState(5).standard_normal(
        (3, 1, jb.d_in)).astype(np.float32)
    want = j_decode(jb, _j(x, dtype), _j(k, dtype), _j(v, dtype),
                    jnp.asarray(tables), jnp.asarray(kv_len), adapters=ja,
                    attn_impl="ref")
    kt, vt = _t(k, dtype), _t(v, dtype)
    got = t_decode(tb, _t(x, dtype), kt, vt, torch.from_numpy(tables),
                   torch.from_numpy(kv_len), adapters=ta)
    for g, w, what in zip(got, want, ("out", "k_pages", "v_pages")):
        _close(g, w, dtype, what)
    assert got[1] is kt and got[2] is vt  # slabs written in place


# ---------------------------------------------------------------------------
# whole chains: batched prefill and the fused decode megastep
#
# fp32 checks the algorithm: the chain minus its embed hop runs on fp32
# embeddings (the reference's embed hop casts to its import-time compute
# dtype), and every output is held at 2e-5.  bf16 runs the whole chain from
# token ids in the reference's compute dtype; there, rounding drifts by
# about one bf16 ulp per hop (0.03 at magnitude 3-4 after four layers, on
# ~0.2% of elements), so element checks stay per hop (above) and on the
# first attention hop's K/V, while the chain is held on its probabilities
# (2e-2) and on greedy tokens wherever the reference's margin is clear.
# ---------------------------------------------------------------------------


def _chain_inputs(zoos, app, dtype, tok):
    """(jax steps, port steps, jax input, port input, compute dtype)."""
    jz, pz = zoos
    jsteps, tsteps = _steps(jz, app), _steps(pz, app)
    if dtype == "float32":
        emb = np.asarray(jsteps[0][0].params["embed"])[tok]
        return (jsteps[1:], tsteps[1:], jnp.asarray(emb),
                torch.from_numpy(emb), torch.float32)
    from repro.models import layers as JL

    assert str(JL.COMPUTE_DTYPE) == dtype
    return (jsteps, tsteps, jnp.asarray(tok), torch.from_numpy(tok),
            torch.bfloat16)


def _check_chain(got_probs, want_probs, got_kvs, want_kvs, dtype):
    want_probs = np.asarray(want_probs)
    _close(got_probs, want_probs, dtype, "probs")
    if dtype == "float32":
        _close(torch.log(got_probs), np.log(want_probs), dtype, "log probs")
        for (gk, gv), (wk, wv) in zip(got_kvs, want_kvs):
            _close(gk, wk, dtype, "k")
            _close(gv, wv, dtype, "v")
    else:
        _close(got_kvs[0][0], want_kvs[0][0], dtype, "first hop k")
        _close(got_kvs[0][1], want_kvs[0][1], dtype, "first hop v")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("app", ["base", "vicuna", "app-lora"])
def test_chain_prefill_fused_matches_jax(zoos, app, dtype):
    from repro.core.blocks import chain_prefill_fused as j_prefill
    from repro_torch.core.blocks import chain_prefill_fused as t_prefill

    rng = np.random.RandomState(11)
    tok = rng.randint(0, 512, size=(3, 16)).astype(np.int32)
    lens = np.asarray([16, 9, 12], np.int32)
    jsteps, tsteps, jx, tx, cdt = _chain_inputs(zoos, app, dtype, tok)
    want = j_prefill(jsteps, jx, jnp.asarray(lens))
    got = t_prefill(tsteps, tx, torch.from_numpy(lens), compute_dtype=cdt)
    _check_chain(got[1], want[1], got[2], want[2], dtype)
    _assert_tokens_agree(got[0].numpy(), np.log(np.asarray(want[1]) + 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("app", ["base", "vicuna", "app-lora"])
def test_chain_decode_fused_matches_jax(zoos, app, dtype):
    from repro.core.blocks import chain_decode_fused as j_decode
    from repro.serving.executor import BlockExecutor
    from repro_torch.core.blocks import chain_decode_fused as t_decode

    tok = np.asarray([5, 77, 300], np.int32)
    jsteps, tsteps, jx, tx, cdt = _chain_inputs(zoos, app, dtype, tok)
    _, pool_index = BlockExecutor._pool_layout(jsteps)
    cfg = jsteps[1][0].cfg
    k, v, tables, kv_len = _pool_inputs(cfg, seed=13)
    n_attn = len(pool_index)
    want = j_decode(jsteps, pool_index, jx, (_j(k, dtype),), (_j(v, dtype),),
                    (jnp.asarray(tables),) * n_attn, jnp.asarray(kv_len),
                    attn_impl="ref")
    kt, vt = _t(k, dtype), _t(v, dtype)
    got = t_decode(tsteps, pool_index, tx, (kt,), (vt,),
                   (torch.from_numpy(tables),) * n_attn,
                   torch.from_numpy(kv_len), compute_dtype=cdt)
    assert got[2][0] is kt and got[3][0] is vt  # slabs written in place
    np.testing.assert_array_equal(got[4].numpy(), kv_len + 1)
    # the pools hold every hop's K/V for the new token: compare them whole
    # in fp32, and in bf16 only their pre-existing (identical) contents
    if dtype == "float32":
        _close(kt, want[2][0], dtype, "k_pages")
        _close(vt, want[3][0], dtype, "v_pages")
    _close(got[1], want[1], dtype, "probs")
    if dtype == "float32":
        _close(torch.log(got[1]), np.log(np.asarray(want[1])), dtype,
               "log probs")
    _assert_tokens_agree(got[0].numpy(), np.log(np.asarray(want[1]) + 1e-30))


# ---------------------------------------------------------------------------
# kernel routes on the CPU: attn_impl="ref" sends prefill attention through
# the flash kernel's plain version and LoRA q/v through the batched-LoRA
# kernel's plain version; both must still match the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("app,idx", [("base", 2), ("app-lora", 3),
                                     ("vicuna", 2)])
def test_block_prefill_raw_ref_route_matches_jax(zoos, app, idx, dtype):
    from repro.core.blocks import block_prefill_raw as j_prefill
    from repro_torch.core.blocks import block_prefill_raw as t_prefill

    jz, pz = zoos
    (jb, ja), (tb, ta) = _steps(jz, app)[idx], _steps(pz, app)[idx]
    x = np.random.RandomState(8).standard_normal(
        (2, 13, jb.d_in)).astype(np.float32)
    want = j_prefill(jb, _j(x, dtype), adapters=ja)
    got = t_prefill(tb, _t(x, dtype), adapters=ta, attn_impl="ref")
    for g, w, what in zip(got, want, ("out", "k_r", "v")):
        _close(g, w, dtype, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 13), (5, 1)])
def test_qkv_lora_ref_route_matches_jax_peft_qkv(zoos, shape, dtype):
    """An app-lora hop's q/k/v through the batched-LoRA plain version
    against JAX's projections plus ``_peft_qkv``, prefill-shaped and
    decode-shaped."""
    from repro.core.blocks import _peft_qkv as j_peft
    from repro_torch.core.blocks import _qkv

    jz, pz = zoos
    (jb, ja), (tb, ta) = _steps(jz, "app-lora")[3], _steps(pz, "app-lora")[3]
    assert [a.kind for a in ta] == ["lora"]
    h = np.random.RandomState(4).standard_normal(
        (*shape, jb.d_in)).astype(np.float32)
    jh = _j(h, dtype)
    p = jb.params
    jq, jk, jv = (jnp.einsum("bsd,dhk->bshk", jh, p[w].astype(jh.dtype))
                  for w in ("wq", "wk", "wv"))
    want = j_peft(jh, jq, jk, jv, ja)
    got = _qkv(_t(h, dtype), tb.compute_params(getattr(torch, dtype)), ta,
               attn_impl="ref")
    for g, w, what in zip(got, want, "qkv"):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, dtype, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("app", ["base", "vicuna", "app-lora"])
def test_chain_prefill_fused_ref_route_matches_jax(zoos, app, dtype):
    from repro.core.blocks import chain_prefill_fused as j_prefill
    from repro_torch.core.blocks import chain_prefill_fused as t_prefill

    rng = np.random.RandomState(12)
    tok = rng.randint(0, 512, size=(3, 16)).astype(np.int32)
    lens = np.asarray([16, 7, 13], np.int32)
    jsteps, tsteps, jx, tx, cdt = _chain_inputs(zoos, app, dtype, tok)
    want = j_prefill(jsteps, jx, jnp.asarray(lens))
    got = t_prefill(tsteps, tx, torch.from_numpy(lens), attn_impl="ref",
                    compute_dtype=cdt)
    _check_chain(got[1], want[1], got[2], want[2], dtype)
    _assert_tokens_agree(got[0].numpy(), np.log(np.asarray(want[1]) + 1e-30))


def test_lora_scaling_is_read_once_as_a_float(zoos):
    _, pz = zoos
    (_, (lora,)) = _steps(pz, "app-lora")[3]
    assert lora.kind == "lora"
    s = lora.lora_scaling(torch.bfloat16)
    assert isinstance(s, float)
    assert s == float(lora.params["scaling"])
    assert lora._scaling[torch.bfloat16] == s  # cached beside the cast


def test_kernel_routes_refuse_what_the_kernels_do_not_take(zoos):
    from repro_torch.core.blocks import block_prefill_raw

    _, pz = zoos
    (tb, ta) = _steps(pz, "app-lora")[3]
    x = torch.zeros(1, 5, tb.d_in)
    with pytest.raises(ValueError, match="CUDA"):  # cuda on a CPU tensor
        block_prefill_raw(tb, x, adapters=ta, attn_impl="cuda")
    with pytest.raises(ValueError):
        block_prefill_raw(tb, x, attn_impl="pallas")
    with pytest.raises(NotImplementedError, match="one LoRA"):
        block_prefill_raw(tb, x, adapters=ta * 2, attn_impl="ref")


def test_windowed_block_prefill_on_ref_equals_the_plain_code(zoos):
    """A block whose config has a sliding window (4), prefilled past it (9
    tokens): the ``ref`` route (flash's plain version with the window)
    equals the plain code (``auto`` on the CPU: the reference's windowed
    attention), output and raw K/V in fp32 (2e-5), and differs from the
    same block without the window."""
    import dataclasses

    from repro_torch.core.blocks import Block, block_prefill_raw

    _, pz = zoos
    (tb, _) = _steps(pz, "app-lora")[3]
    windowed = Block(**{f.name: getattr(tb, f.name)
                        for f in dataclasses.fields(Block)
                        if not f.name.startswith("_")})
    windowed.cfg = dataclasses.replace(tb.cfg, sliding_window=4)
    rng = np.random.RandomState(21)
    x = torch.from_numpy(rng.standard_normal((2, 9, tb.d_in))
                         .astype(np.float32))
    got = block_prefill_raw(windowed, x, attn_impl="ref")
    want = block_prefill_raw(windowed, x)  # auto on the CPU: the plain code
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    full = block_prefill_raw(tb, x, attn_impl="ref")[0]
    assert not torch.allclose(full[:, 4:], got[0][:, 4:], rtol=2e-5,
                              atol=2e-5)
    torch.testing.assert_close(full[:, :4], got[0][:, :4], rtol=2e-5,
                               atol=2e-5)  # inside the window: no mask
