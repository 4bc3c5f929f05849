"""The PyTorch port's serving engine: KV-pool units, token parity inside the
port (fused megastep against the per-hop oracle, bitwise), across
frameworks (the JAX engine and the port serve the same requests on the
same parameters with identical tokens in fp32), and token-exact spill and
recalc preemption.

The JAX package reads its compute dtype once, at import
(``repro/models/layers.py:22``), so its fp32 engine runs in a subprocess
with ``REPRO_COMPUTE_DTYPE=float32``; parameters come from the same seeded
recipe on both sides (``test_torch_blocks.jax_demo_trees``), and the
subprocess reports its block ids so the test can check that both sides
served the same zoo.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.serving.api import ServeRequest
from repro_torch.serving.engine import BlockEngine, EngineConfig
from repro_torch.serving.kv_pool import TRASH_PAGE, KVManager, KVPool

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
APPS = ("base", "vicuna", "app-lora")

_JAX_ENGINE = """
import sys
import numpy as np
sys.path.insert(0, {tests!r})
from test_torch_blocks import jax_demo_trees, jax_zoo
from repro.serving.api import ServeRequest
from repro.serving.engine import BlockEngine

reqs = np.load({inp!r})
zoo = jax_zoo(*jax_demo_trees())
engine = BlockEngine(zoo, max_len=64)
apps = list(reqs["apps"])
rids = [engine.submit(ServeRequest(app=str(a), gen_len=int(g),
                                   prompt_tokens=reqs[f"p{{i}}"]))
        for i, (a, g) in enumerate(zip(apps, reqs["gen_lens"]))]
out = {{r.rid: r for r in engine.drain()}}
np.savez({out!r}, ids=np.asarray(sorted(zoo.blocks)),
         **{{f"t{{i}}": out[r].tokens for i, r in enumerate(rids)}})
"""


def _requests(vocab, n=6, seed=0, gen_lens=(5, 6, 7), apps=APPS):
    rng = np.random.RandomState(seed)
    return [ServeRequest(
        app=apps[i % len(apps)], gen_len=gen_lens[i % len(gen_lens)],
        prompt_tokens=rng.randint(0, vocab, size=int(rng.randint(8, 20)))
        .astype(np.int32)) for i in range(n)]


def _serve(engine, reqs):
    reqs = [ServeRequest(app=r.app, gen_len=r.gen_len,
                         prompt_tokens=r.prompt_tokens) for r in reqs]
    rids = [engine.submit(r) for r in reqs]
    out = {r.rid: r for r in engine.drain()}
    assert sorted(out) == sorted(rids)
    return [out[r] for r in rids]


def _engine(zoo, dtype="float32", max_len=64, **kw):
    return BlockEngine(zoo, max_len=max_len, config=EngineConfig(
        device="cpu", compute_dtype=dtype, **kw))


@pytest.fixture(scope="module")
def zoo():
    from test_torch_blocks import jax_demo_trees, port_zoo

    return port_zoo(*jax_demo_trees())


# ---------------------------------------------------------------------------
# KV pool / manager units
# ---------------------------------------------------------------------------


def test_pool_alloc_free_and_gauges():
    from repro_torch.observability import MetricsRegistry

    m = MetricsRegistry()
    pool = KVPool(9, 4, 2, 8, dtype=torch.float32, device="cpu", metrics=m)
    assert pool.k_pages.shape == (9, 4, 2, 8) and pool.free_pages == 8
    a = pool.alloc(0, 1, tokens=9)   # 3 pages
    b = pool.alloc(1, 1, tokens=4)   # 1 page
    assert len(a.pages) == 3 and a.max_len == 12 and len(b.pages) == 1
    assert TRASH_PAGE not in a.pages + b.pages
    assert pool.used_pages == 4
    assert m.snapshot()["gauges"]["kv_used_pages[2x8]"] == 4
    assert not pool.can_fit(tokens=8, n_slots=3)  # 6 pages > 4 free
    with pytest.raises(MemoryError):
        pool.alloc(2, 1, tokens=100)
    pool.free_request(0)
    assert pool.free_pages == 7 and pool.page_bytes == 2 * 4 * 2 * 8 * 4
    with pytest.raises(ValueError):
        KVPool(1, 4, 2, 8, device="cpu")


def test_block_table_pads_with_trash_page():
    pool = KVPool(12, 4, 1, 8, dtype=torch.float32, device="cpu")
    pool.alloc(0, 0, tokens=10)  # 3 pages
    pool.alloc(1, 0, tokens=3)   # 1 page
    table = pool.block_table([(0, 0), (1, 0)])
    assert table.dtype == np.int32 and table.shape == (2, 3)
    assert list(table[0]) == pool.slots[(0, 0)].pages
    assert list(table[1, 1:]) == [TRASH_PAGE, TRASH_PAGE]


def test_write_prefill_scatters_into_slot_pages():
    pool = KVPool(8, 4, 2, 8, dtype=torch.bfloat16, device="cpu")
    pool.alloc(5, 3, tokens=10)
    rng = np.random.RandomState(0)
    k = torch.from_numpy(rng.standard_normal((1, 6, 2, 8)).astype(np.float32))
    v = -k
    pool.write_prefill(5, 3, k, v)
    pages = pool.slots[(5, 3)].pages
    got = pool.k_pages[pages].reshape(-1, 2, 8)
    assert torch.equal(got[:6], k[0].to(torch.bfloat16))
    assert torch.equal(got[6:], torch.zeros_like(got[6:]))  # padded tail
    assert torch.equal(pool.v_pages[pages].reshape(-1, 2, 8)[:6],
                       v[0].to(torch.bfloat16))
    assert torch.equal(pool.k_pages[TRASH_PAGE],
                       torch.zeros_like(pool.k_pages[0]))


def test_manager_spill_restore_roundtrip(zoo):
    steps = [(zoo.blocks[s.block_id], ()) for s in zoo.chains["base"].steps]
    kv = KVManager(page_size=16, num_pages=64, dtype=torch.float32,
                   device="cpu")
    assert kv.plan(steps) == {(4, 32): 4}
    assert kv.can_admit(steps, tokens=40)
    _, pool = kv.pool_for(steps[1][0])
    for i, (block, _) in enumerate(steps):
        if block.has_kv:
            pool.alloc(7, i, tokens=40)
            pool.k_pages[pool.slots[(7, i)].pages] = float(i)
            pool.v_pages[pool.slots[(7, i)].pages] = -float(i)
    before = {k: (pool.k_pages[s.pages].clone(), pool.v_pages[s.pages].clone())
              for k, s in pool.slots.items()}
    assert kv.kv_bytes(7) == 4 * 3 * pool.page_bytes
    snap = kv.spill(7)
    assert snap.kv_bytes == 4 * 3 * pool.page_bytes and pool.used_pages == 0
    pool.alloc(99, 0, tokens=16)  # restore lands on other pages
    kv.restore(7, snap, tokens=40)
    for key, (k, v) in before.items():
        s = pool.slots[key]
        assert torch.equal(pool.k_pages[s.pages], k)
        assert torch.equal(pool.v_pages[s.pages], v)


def test_preempt_strategy_uses_h100_constants():
    from repro_torch.serving import cost_model

    assert cost_model.PEAK_FLOPS == 989e12 and cost_model.HBM_BW == 3.35e12
    assert cost_model.preempt_readmit_strategy(1 << 20, 1e15)[0] == "spill"
    assert cost_model.preempt_readmit_strategy(1 << 30, 1e6)[0] == "recalc"


# ---------------------------------------------------------------------------
# parity inside the port: fused megastep == per-hop oracle, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("app", APPS)
def test_fused_matches_per_hop_bitwise(zoo, app, dtype):
    """Single-app group with ragged prompts: the fused megastep and the
    per-hop path give bitwise-equal token streams.  Their prefills run at
    different shapes (one padded batch against one request at a time), so
    the final distributions agree to the dtype's tolerance, not bitwise,
    as in tests/test_fused_decode.py."""
    reqs = _requests(512, n=2, seed=7, gen_lens=(4,), apps=(app,))
    fused = _engine(zoo, dtype)
    hop = _engine(zoo, dtype, fused=False)
    got, ref = _serve(fused, reqs), _serve(hop, reqs)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else dict(
        rtol=2e-2, atol=2e-2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.tokens, r.tokens)
        np.testing.assert_allclose(g.probs_last, r.probs_last, **tol)
    assert not fused.executor.decode_states  # all groups retired at drain
    assert fused.stats["decode_tokens"] == hop.stats["decode_tokens"]
    assert fused.stats["group_calls"] < hop.stats["group_calls"]
    # every paged-attention call the executor issued is counted
    n_attn = sum(1 for s in zoo.chains[app].steps
                 if zoo.blocks[s.block_id].has_kv)
    assert fused.stats["attn_calls"] == n_attn * fused.stats["group_calls"]


def test_fused_mixed_apps_match_per_hop(zoo):
    reqs = _requests(512, n=6, seed=13)
    got = _serve(_engine(zoo, "bfloat16"), reqs)
    ref = _serve(_engine(zoo, "bfloat16", fused=False), reqs)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.tokens, r.tokens)


# ---------------------------------------------------------------------------
# parity across frameworks: identical tokens in fp32
# ---------------------------------------------------------------------------


def test_engine_tokens_match_jax_engine_fp32(zoo, tmp_path):
    reqs = _requests(512, n=6, seed=3)
    inp, out = tmp_path / "reqs.npz", tmp_path / "jax_tokens.npz"
    np.savez(inp, apps=np.asarray([r.app for r in reqs]),
             gen_lens=np.asarray([r.gen_len for r in reqs]),
             **{f"p{i}": r.prompt_tokens for i, r in enumerate(reqs)})
    env = dict(os.environ, REPRO_COMPUTE_DTYPE="float32", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    script = _JAX_ENGINE.format(tests=str(ROOT / "tests"), inp=str(inp),
                                out=str(out))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = np.load(out)
    assert list(want["ids"]) == sorted(zoo.blocks)  # the same zoo
    got = _serve(_engine(zoo, "float32"), reqs)
    assert {r.app for r in reqs} == set(APPS)
    for i, (g, r) in enumerate(zip(got, reqs)):
        assert len(g.tokens) == r.gen_len
        np.testing.assert_array_equal(g.tokens, want[f"t{i}"],
                                      err_msg=f"app={r.app}")


# ---------------------------------------------------------------------------
# preemption: spill and recalc resume token-exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["spill", "recalc"])
def test_preemption_token_exact(zoo, strategy):
    reqs = _requests(512, n=3, seed=19)
    ref = _serve(_engine(zoo, "bfloat16"), reqs)
    engine = _engine(zoo, "bfloat16")
    rids = [engine.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                       prompt_tokens=r.prompt_tokens))
            for r in reqs]
    engine.step()
    engine.step()  # groups are device-resident with buffered tokens
    assert engine.executor.buffered(rids[0]) > 0
    assert engine.preempt(rids[0], strategy=strategy)
    out = {r.rid: r for r in engine.drain()}
    for rid, r in zip(rids, ref):
        np.testing.assert_array_equal(out[rid].tokens, r.tokens)
    assert out[rids[0]].info["preemptions"] == 1
    key = "spills" if strategy == "spill" else "recalc_readmits"
    assert engine.stats[key] == 1
    assert all(p.used_pages == 0 for p in engine.pools.values())


# ---------------------------------------------------------------------------
# engine surface
# ---------------------------------------------------------------------------


def test_generate_gen_len_zero_and_trace(zoo, tmp_path):
    engine = _engine(zoo)
    prompts = np.random.RandomState(29).randint(0, 512, size=(3, 12))
    res = engine.generate(zoo.chains["base"], prompts.astype(np.int32),
                          gen_len=0)
    assert res.tokens.shape == (3, 0) and res.probs_last is None
    assert engine.step() is None
    res = engine.generate(zoo.chains["vicuna"], prompts.astype(np.int32),
                          gen_len=3)
    assert res.tokens.shape == (3, 3) and res.probs_last.shape == (3, 512)
    engine.write_trace(str(tmp_path / "trace.json"))
    engine.write_metrics(str(tmp_path / "metrics.json"))
    assert (tmp_path / "trace.json").stat().st_size > 0
    # gen_len=0 completes at admission without a first token
    assert engine.metrics.snapshot()["histograms"]["ttft_s"]["count"] == 3


def test_engine_config_guards(zoo):
    with pytest.raises(NotImplementedError, match="speculation"):
        _engine(zoo, speculation=True)
    with pytest.raises(ValueError):
        _engine(zoo, attn_impl="pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            BlockEngine(zoo, max_len=64, config=EngineConfig(device="cuda"))


def test_build_demo_zoo_on_cpu():
    from repro_torch.serving.demo import build_demo_zoo

    cfg, params, z = build_demo_zoo(0, device="cpu")
    assert set(z.chains) == set(APPS)
    assert len(z.equivalences) == 2  # the FPFT layer keeps its edge
    assert params["layers"]["wq"].shape == (4, 256, 8, 32)
    cfg2, _, z2 = build_demo_zoo(0, device="cpu")
    assert sorted(z2.blocks) == sorted(z.blocks)  # seeded: same ids
    res = _serve(_engine(z, "bfloat16"), _requests(cfg.vocab_size, n=3))
    assert [len(r.tokens) for r in res] == [5, 6, 7]
