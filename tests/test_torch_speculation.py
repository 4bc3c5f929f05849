"""The port's speculative decoding (paper §5.2, DESIGN.md §2): the
draft-verify megastep ``chain_decode_spec_fused`` and the engine's
``EngineConfig(speculation=True)`` path.

Verification replays the plain fused step's calls and the accept rule is
verify-exact, so everything here is held bitwise inside the port: the
megastep against ``lookahead`` plain ``chain_decode_fused`` calls on the
same pools, and every engine case of tests/test_spec_decode.py (forced
accept, the budget clamp, forced reject, the gate, mixed apps, preemption
in the middle of speculation) against the port's spec-OFF engine, in bf16
and fp32.  Across frameworks the port's speculative run gives the JAX
engine's tokens and the same attempt and hit counts in fp32; the JAX
engine runs in a subprocess with ``REPRO_COMPUTE_DTYPE=float32``, as in
tests/test_torch_engine.py.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.blocks import (
    ATTENTION_KINDS,
    chain_decode_fused,
    chain_decode_spec_fused,
    chain_prefill_fused,
    chain_signature,
)
from repro_torch.serving.api import ServeRequest
from repro_torch.serving.engine import BlockEngine, EngineConfig
from repro_torch.serving.executor import BlockExecutor
from repro_torch.serving.kv_pool import KVManager

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
APPS = ("base", "vicuna", "app-lora")
DTYPES = ("bfloat16", "float32")
VOCAB = 512
PAGE = 16

_JAX_SPEC_ENGINE = """
import sys
import numpy as np
sys.path.insert(0, {tests!r})
from test_torch_blocks import jax_demo_trees, jax_zoo
from repro.serving.api import ServeRequest
from repro.serving.engine import BlockEngine, EngineConfig

reqs = np.load({inp!r})
zoo = jax_zoo(*jax_demo_trees())
engine = BlockEngine(zoo, max_len=64, config=EngineConfig(speculation=True))
rids = [engine.submit(ServeRequest(app=str(a), gen_len=int(g),
                                   prompt_tokens=reqs[f"p{{i}}"]))
        for i, (a, g) in enumerate(zip(reqs["apps"], reqs["gen_lens"]))]
out = {{r.rid: r for r in engine.drain()}}
stats = engine.stats
np.savez({out!r}, spec_attempts=stats["spec_attempts"],
         spec_hits=stats["spec_hits"], steps=stats["steps"],
         **{{f"t{{i}}": out[r].tokens for i, r in enumerate(rids)}})
"""


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
def zoo():
    from test_torch_blocks import jax_demo_trees, port_zoo

    return port_zoo(*jax_demo_trees())


def _requests(n, seed=0, gen_lens=(6, 7, 8), apps=("base",)):
    rng = np.random.RandomState(seed)
    return [ServeRequest(
        app=apps[i % len(apps)], gen_len=gen_lens[i % len(gen_lens)],
        prompt_tokens=rng.randint(0, VOCAB, size=int(rng.randint(8, 20)))
        .astype(np.int32)) for i in range(n)]


def _serve(engine, reqs):
    reqs = [ServeRequest(app=r.app, gen_len=r.gen_len,
                         prompt_tokens=r.prompt_tokens) for r in reqs]
    rids = [engine.submit(r) for r in reqs]
    out = {r.rid: r for r in engine.drain()}
    assert sorted(out) == sorted(rids)
    return [out[r] for r in rids]


def _engine(zoo, dtype, max_len=64, **kw):
    return BlockEngine(zoo, max_len=max_len, config=EngineConfig(
        device="cpu", compute_dtype=dtype, **kw))


def _spec_pair(zoo, dtype, max_len=64, **kw):
    return (_engine(zoo, dtype, max_len, speculation=True, **kw),
            _engine(zoo, dtype, max_len))


def _assert_same_tokens(got, ref, reqs, what=""):
    for g, r, req in zip(got, ref, reqs):
        np.testing.assert_array_equal(
            g.tokens, r.tokens,
            err_msg=f"app={req.app} gen_len={req.gen_len} {what}")
        assert len(g.tokens) == req.gen_len


def _steps(zoo, app):
    return [(zoo.blocks[s.block_id],
             tuple(zoo.blocks[a] for a in s.adapter_ids))
            for s in zoo.chains[app].steps]


def _sur_steps(zoo, steps, ratio):
    return [(zoo.blocks[zoo.surrogate_for(b.id, ratio)]
             if "w_gate" in b.params else b, a) for b, a in steps]


# ---------------------------------------------------------------------------
# the megastep against plain fused steps on the same pools
# ---------------------------------------------------------------------------


def _prefilled(steps, dtype, prompts, slot):
    """A KV manager holding ``prompts`` prefilled through ``steps`` (one
    padded call, the ref route), each slot ``slot`` tokens wide.  Returns
    (kv, pool_keys, pool_index, tables, pending tokens, kv_len)."""
    kv = KVManager(PAGE, 1 + 4 * len(prompts) * -(-slot // PAGE), dtype=dtype,
                   device="cpu")
    for rid in range(len(prompts)):
        for i, (block, _) in enumerate(steps):
            if block.has_kv:
                kv.pool_for(block)[1].alloc(rid, i, slot)
    S = max(len(p) for p in prompts)
    tok = torch.zeros(len(prompts), S, dtype=torch.int32)
    for b, p in enumerate(prompts):
        tok[b, :len(p)] = torch.from_numpy(p)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    nxt, _, kvs = chain_prefill_fused(steps, tok, lens, attn_impl="ref",
                                      compute_dtype=dtype)
    tables, hop = [], 0
    for i, (block, _) in enumerate(steps):
        if not block.has_kv:
            continue
        _, pool = kv.pool_for(block)
        k_r, v = kvs[hop]
        for b, p in enumerate(prompts):
            pool.write_prefill(b, i, k_r[b:b + 1, :len(p)], v[b:b + 1, :len(p)])
        tables.append(torch.from_numpy(pool.block_table(
            [(b, i) for b in range(len(prompts))])))
        hop += 1
    pool_keys, pool_index = BlockExecutor._pool_layout(steps)
    return kv, pool_keys, pool_index, tables, nxt, lens


def _slabs(kv, pool_keys):
    return ([kv.pools[k].k_pages.clone() for k in pool_keys],
            [kv.pools[k].v_pages.clone() for k in pool_keys])


def _rows(pages, table, lo, hi):
    """K or V of positions lo..hi-1 of one row, gathered through its
    table: (hi - lo, KVH, hd)."""
    pos = torch.arange(lo, hi)
    return pages[table[pos // PAGE].long(), pos % PAGE]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ratio", [0.0, 0.25])
@pytest.mark.parametrize("app", ["base", "app-lora"])
def test_spec_megastep_matches_plain_steps(zoo, app, ratio, dtype):
    """One speculative megastep (lookahead 4) against four plain fused
    steps from the same pools, ref route: the committed candidates are the
    plain stream's tokens, the new pending token and its distribution are
    the plain step's bit for bit, kv_len advances by the commit count, and
    the K/V of every committed position is the plain path's; budgets of
    4, 2 and 1 clamp the accepted drafts to 3, 1 and 0."""
    k = 4
    dt = getattr(torch, dtype)
    steps = _steps(zoo, app)
    sur_steps = _sur_steps(zoo, steps, ratio)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, VOCAB, size=n).astype(np.int32)
               for n in (9, 15, 16)]  # the last ends a page: drafts cross it
    kv, pool_keys, pool_index, tables, tok, kv_len = _prefilled(
        steps, dt, prompts, slot=16 + 8 + k)
    plain_k, plain_v = _slabs(kv, pool_keys)
    spec_k, spec_v = _slabs(kv, pool_keys)
    stream, probs_by_step = [tok], []
    cur, cur_len = tok, kv_len
    for _ in range(k):
        cur, probs, _, _, cur_len = chain_decode_fused(
            steps, pool_index, cur, plain_k, plain_v, tables, cur_len,
            attn_impl="ref", compute_dtype=dt)
        stream.append(cur)
        probs_by_step.append(probs)
    budget = torch.tensor([k, 2, 1], dtype=torch.int32)
    (commit_tok, commit_cnt, accepted, attempts, nxt, probs, _, _,
     new_len) = chain_decode_spec_fused(
        steps, sur_steps, pool_index, tok, spec_k, spec_v, tables, kv_len,
        budget, lookahead=k, attn_impl="ref", compute_dtype=dt)
    assert commit_tok.shape == (3, k)
    assert attempts.tolist() == [3, 1, 0]
    assert torch.all(accepted <= attempts)
    if ratio == 0.0:  # the surrogate is the model: every draft is a hit
        assert accepted.tolist() == attempts.tolist()
    assert torch.equal(commit_cnt, accepted + 1)
    assert torch.equal(new_len, kv_len + commit_cnt)
    for b in range(3):
        c = int(commit_cnt[b])
        want = torch.stack([s[b] for s in stream])  # p, n_0, .., n_{k-1}
        assert torch.equal(commit_tok[b, :c], want[:c])
        assert torch.equal(nxt[b], want[c])
        assert torch.equal(probs[b], probs_by_step[c - 1][b])
        lo, hi = int(kv_len[b]), int(kv_len[b]) + c
        for hop, pi in enumerate(pool_index):
            for got, ref in ((spec_k[pi], plain_k[pi]),
                             (spec_v[pi], plain_v[pi])):
                assert torch.equal(_rows(got, tables[hop][b], 0, hi),
                                   _rows(ref, tables[hop][b], 0, hi)), (b, lo)


def test_spec_megastep_needs_two_tokens_of_lookahead(zoo):
    steps = _steps(zoo, "base")
    with pytest.raises(ValueError, match="lookahead"):
        chain_decode_spec_fused(steps, steps, [0] * 4, None, [], [], [], None,
                                None, lookahead=1)


def test_spec_fn_rejects_a_surrogate_with_another_kv_layout(zoo):
    """A head-pruned surrogate has another KV signature: it cannot share
    the full chain's pools, so the executor refuses it."""
    from repro_torch.core.surrogates import build_surrogate

    steps = _steps(zoo, "base")
    sur = [(build_surrogate(b, 0.5, prune_kv=True) if b.has_kv else b, a)
           for b, a in steps]
    ex = BlockExecutor(device="cpu", table_width=16, max_lanes=16)
    with pytest.raises(ValueError, match="KV-pool layout"):
        ex.spec_fn(steps, sur, chain_signature(steps), 4)
    fn, keys, n_attn = ex.spec_fn(steps, _sur_steps(zoo, steps, 0.25),
                                  chain_signature(steps), 4)
    assert n_attn == 4 and keys == ((4, 32),)


# ---------------------------------------------------------------------------
# the engine: spec-ON streams equal the spec-OFF engine's, bitwise
# ---------------------------------------------------------------------------


def _count_spec_calls(engine):
    """Wrap the engine's executor so speculative calls are counted, each
    checked to sync the host once."""
    ex = engine.executor
    calls = []
    inner = ex.spec_step

    def spec_step(states, *args, **kw):
        before = engine.stats["host_syncs"]
        out = inner(states, *args, **kw)
        assert engine.stats["host_syncs"] == before + 1
        calls.append(len(states))
        return out

    ex.spec_step = spec_step
    return calls


@pytest.mark.parametrize("dtype", DTYPES)
def test_forced_accept_token_exact(zoo, dtype):
    """prune_ratio=0 surrogates are the exact model: all attempts hit,
    several tokens commit per step, the stream is the spec-OFF engine's,
    and the kernel-call counters follow the 2k - 1 walks of each call."""
    spec, plain = _spec_pair(zoo, dtype, spec_prune_ratio=0.0)
    calls = _count_spec_calls(spec)
    reqs = _requests(n=2, seed=7, gen_lens=(8,), apps=("app-lora",))
    _assert_same_tokens(_serve(spec, reqs), _serve(plain, reqs), reqs)
    st = spec.stats
    assert st["spec_attempts"] > 0
    assert st["spec_hits"] == st["spec_attempts"]
    assert spec.metrics.gauge("spec_accept_rate").value == 1.0
    assert st["steps"] < plain.stats["steps"]
    n_attn = sum(b.has_kv for b, _ in _steps(zoo, "app-lora"))
    k = spec.config.spec_lookahead
    walks = st["group_calls"] + 2 * (k - 1) * len(calls)
    assert calls and st["attn_calls"] == n_attn * walks
    prefills = st["prefill_attn_calls"] // n_attn
    assert st["lora_calls"] == 2 * n_attn * (walks + prefills)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forced_accept_near_budget_clamp(zoo, dtype):
    """gen_len barely above the lookahead: the per-lane budget clamp stops
    perfect drafts from committing past the generation budget."""
    spec, plain = _spec_pair(zoo, dtype, spec_prune_ratio=0.0,
                             spec_lookahead=4)
    reqs = _requests(n=1, seed=11, gen_lens=(4,))
    _assert_same_tokens(_serve(spec, reqs), _serve(plain, reqs), reqs)
    assert spec.stats["spec_attempts"] > 0


def _negate_lm_head(engine, app):
    """Pre-build the app's speculation state, then replace the surrogate
    chain's lm_head with a negated copy: draft argmaxes become the model's
    argmin, so verify rejects every draft."""
    steps = engine._steps(engine.zoo.chains[app], None)[0]
    ss = engine._spec_state(chain_signature(steps), steps)
    head, adapters = ss.sur_steps[-1]
    assert head.kind == "lm_head"
    p = dict(head.params)
    p["lm_head"] = -p["lm_head"]
    ss.sur_steps[-1] = (dataclasses.replace(head, id=head.id + "-neg",
                                            params=p, _compute={},
                                            _scaling={}), adapters)
    return ss


@pytest.mark.parametrize("dtype", DTYPES)
def test_forced_reject_token_exact(zoo, dtype):
    """Every draft rejected: each spec step commits exactly one token, the
    output is the spec-OFF engine's, the hit counter stays at zero and the
    engine takes as many steps as plain decode."""
    spec, plain = _spec_pair(zoo, dtype, spec_min_accept=0.0)
    _negate_lm_head(spec, "base")
    reqs = _requests(n=2, seed=13, gen_lens=(6,))
    _assert_same_tokens(_serve(spec, reqs), _serve(plain, reqs), reqs)
    assert spec.stats["spec_attempts"] > 0
    assert spec.stats["spec_hits"] == 0
    assert spec.stats["steps"] == plain.stats["steps"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_reject_gate_disables_then_retries(zoo, dtype):
    """The accept-rate EMA disables a signature that keeps missing, the
    cooldown re-enables it ``spec_retry_steps`` later, and the stream stays
    the spec-OFF engine's throughout."""
    spec = _engine(zoo, dtype, speculation=True, spec_min_accept=0.5,
                   spec_ema_alpha=0.5, spec_retry_steps=3)
    ss = _negate_lm_head(spec, "base")
    sig = chain_signature(_steps(zoo, "base"))
    reqs = _requests(n=1, seed=17, gen_lens=(16,))
    spec.submit(ServeRequest(app="base", gen_len=16,
                             prompt_tokens=reqs[0].prompt_tokens))
    seen_disabled = seen_retry = False
    out = []
    while (res := spec.step()) is not None:
        out.extend(res)
        if not ss.enabled:
            seen_disabled = True
            assert ss.cooldown > 0 or ss.ema == 1.0
        elif seen_disabled:
            seen_retry = True
    assert seen_disabled and seen_retry  # ema 1 -> 0.5 -> 0.25 < 0.5
    assert spec._spec[sig] is ss
    ref = _serve(_engine(zoo, dtype), reqs)
    _assert_same_tokens(out, ref, reqs)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mixed_apps_token_exact(zoo, dtype):
    """Six mixed-app mixed-gen_len requests at the default prune ratio:
    partial accepts, speculation-aware grouping (app-lora's signature
    stays off: its probe fidelity is under the 0.9 gate), membership
    churn as short requests finish — streams equal spec-OFF's."""
    spec, plain = _spec_pair(zoo, dtype)
    reqs = _requests(n=6, seed=19, gen_lens=(5, 9, 12), apps=APPS)
    _assert_same_tokens(_serve(spec, reqs), _serve(plain, reqs), reqs,
                        "spec diverged")
    assert spec.stats["spec_attempts"] > 0
    assert 0 < spec.stats["spec_hits"] < spec.stats["spec_attempts"]
    assert not spec.executor.decode_states  # all groups retired at drain
    gates = {app: spec._spec[chain_signature(_steps(zoo, app))]
             for app in APPS}
    assert gates["base"].enabled and gates["vicuna"].enabled
    assert not gates["app-lora"].enabled
    assert gates["app-lora"].fidelity < 0.9 < gates["base"].fidelity


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("strategy", ["spill", "recalc"])
def test_preemption_mid_speculation_token_exact(zoo, strategy, dtype):
    """Preempting a lane whose group has uncommitted spec buffers syncs the
    exact per-lane commit counts to the host first; both §5.1 readmit
    paths resume token-exact, and the churn gate pauses speculation."""
    spec, plain = _spec_pair(zoo, dtype, spec_churn_steps=2)
    reqs = _requests(n=3, seed=23, gen_lens=(10, 12, 14))
    rids = [spec.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                     prompt_tokens=r.prompt_tokens))
            for r in reqs]
    spec.step()
    spec.step()  # groups device-resident with buffered spec commits
    assert spec.stats["spec_attempts"] > 0
    assert any(spec.executor.buffered(r) > 1 for r in rids)
    assert spec.preempt(rids[0], strategy=strategy)
    assert spec._spec_churn == 2  # speculation paused after the preemption
    out = {r.rid: r for r in spec.drain()}
    _assert_same_tokens([out[r] for r in rids], _serve(plain, reqs), reqs,
                        f"after {strategy} preemption")
    assert out[rids[0]].info["preemptions"] == 1
    key = "spills" if strategy == "spill" else "recalc_readmits"
    assert spec.stats[key] == 1
    assert all(p.used_pages == 0 for p in spec.pools.values())


def test_spec_slots_carry_lookahead_headroom(zoo):
    """Slots (and the default pool size) hold ``spec_lookahead`` tokens
    past prompt + generation, so a draft written at kv_len + k - 1 stays
    inside the request's own pages."""
    spec = _engine(zoo, "float32", speculation=True, spec_lookahead=5)
    plain = _engine(zoo, "float32")
    assert spec._slot_tokens(17, 8) == 17 + 8 + 5
    assert plain._slot_tokens(17, 8) == 17 + 8
    assert spec.kv.num_pages > plain.kv.num_pages
    for name in ("spec_attempts", "spec_hits"):
        assert spec.stats[name] == plain.stats[name] == 0
    assert spec.metrics.gauge("spec_accept_rate").value == 0.0


def test_probe_attention_calls_counted(zoo):
    """The fidelity probe runs each pruned attention-bearing hop's block
    and surrogate once (two prefill attentions, the flash kernel on the
    card), counted in ``probe_attn_calls`` once per signature built."""
    spec = _engine(zoo, "float32", speculation=True)
    assert spec.stats["probe_attn_calls"] == 0
    want = 0
    for app in APPS:
        steps = spec._steps(spec.zoo.chains[app], None)[0]
        sig = chain_signature(steps)
        if sig not in spec._spec:
            want += 2 * sum(b.kind in ATTENTION_KINDS and "w_gate" in b.params
                            for b, _ in steps)
        spec._spec_state(sig, steps)
        assert spec.stats["probe_attn_calls"] == want
    spec._spec_state(sig, steps)  # built: no probe
    assert spec.stats["probe_attn_calls"] == want > 0


# ---------------------------------------------------------------------------
# across frameworks: the JAX engine's speculative run in fp32
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_spec_run(tmp_path_factory):
    """The JAX engine's speculative fp32 run of six mixed-app requests,
    from one subprocess."""
    reqs = _requests(n=6, seed=29, gen_lens=(7, 10, 12), apps=APPS)
    tmp = tmp_path_factory.mktemp("jax_spec")
    inp, out = tmp / "reqs.npz", tmp / "jax_spec.npz"
    np.savez(inp, apps=np.asarray([r.app for r in reqs]),
             gen_lens=np.asarray([r.gen_len for r in reqs]),
             **{f"p{i}": r.prompt_tokens for i, r in enumerate(reqs)})
    env = dict(os.environ, REPRO_COMPUTE_DTYPE="float32", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    script = _JAX_SPEC_ENGINE.format(tests=str(ROOT / "tests"),
                                     inp=str(inp), out=str(out))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return reqs, dict(np.load(out))


@pytest.mark.parametrize("attn_impl", ["auto", "ref"])
def test_spec_tokens_and_counts_match_jax_engine_fp32(zoo, jax_spec_run,
                                                      attn_impl):
    """Same tokens, same attempts and hits, same engine steps: both
    packages draft with the same surrogates and gate the same signatures."""
    reqs, want = jax_spec_run
    engine = _engine(zoo, "float32", speculation=True, attn_impl=attn_impl)
    got = _serve(engine, reqs)
    for i, (g, r) in enumerate(zip(got, reqs)):
        assert len(g.tokens) == r.gen_len
        np.testing.assert_array_equal(g.tokens, want[f"t{i}"],
                                      err_msg=f"app={r.app}")
    assert engine.stats["spec_attempts"] == int(want["spec_attempts"]) > 0
    assert engine.stats["spec_hits"] == int(want["spec_hits"]) > 0
    assert engine.stats["steps"] == int(want["steps"])
