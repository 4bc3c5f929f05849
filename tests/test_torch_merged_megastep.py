"""The merged megastep (``core/blocks.py`` ``MergedChains``, run by
``serving/executor.py``): one decode walk over the lanes of several apps'
chains, each shared block's weights read once, against each app's own
megastep and the per-hop oracle, on the CPU.

Three sides run the same requests from pools prefilled alike: the merged
megastep (with its megastep graphs: the lanes padded to their bucket),
each app's own megastep run eagerly over its lanes of the same group, and
the per-hop path (``BlockEngine._run_hops``).  Each lane's tokens, kv
lengths and K/V pages must agree bitwise; pad lanes write only the trash
page.  The comparisons run in bf16, the type the port serves in; the
CPU's fp32 elementwise passes do not keep a row's bits when the batch
grows (``tests/test_torch_megastep_graph.py``).

The card's tests of the merged walk (capture and replay) are at the end,
marked ``cuda``.
"""
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import pytest
import torch

from repro_torch.core.blocks import MergedChains, chain_signature
from repro_torch.serving import executor as executor_module
from repro_torch.serving.api import ServeRequest
from repro_torch.serving.engine import BlockEngine, EngineConfig
from repro_torch.serving.executor import BlockExecutor, _bucket
from repro_torch.serving.kv_pool import TRASH_PAGE, KVManager

DTYPE = torch.bfloat16
PAGE, MAX_LEN = 4, 64
WIDTH = MAX_LEN // PAGE
VOCAB = 512
APPS = ("base", "vicuna", "app-lora")

# lanes of the three apps (rid % 3), interleaved: 9 lanes in bucket 16;
# 2 and 5 finish while 9 and 10 join; 11-13 join; then 5 lanes in bucket 8
SCHEDULE = ([list(range(9))] * 2 + [[0, 1, 3, 4, 6, 7, 8, 9, 10]] * 2
            + [[0, 1, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13]] * 2
            + [[0, 4, 8, 12, 13]] * 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    from test_torch_blocks import jax_demo_trees

    return jax_demo_trees()


@pytest.fixture(scope="module")
def zoo(trees):
    from test_torch_blocks import port_zoo

    return port_zoo(*trees)


@dataclass
class _State:
    """A request's state as the executor reads it (the engine's
    ``_ReqState``, duck-typed)."""
    rid: int
    app: str
    steps: list
    prompt_tokens: np.ndarray
    prompt_len: int
    gen_len: int = 10 ** 6
    kv_len: int = 0
    next_token: Optional[int] = None
    probs_last: Optional[np.ndarray] = None
    tokens: List[int] = field(default_factory=list)


def _steps(zoo, app):
    return [(zoo.blocks[s.block_id],
             tuple(zoo.blocks[a] for a in s.adapter_ids))
            for s in zoo.chains[app].steps]


def _bind_nothing(*args):
    """``BlockExecutor._free_graph`` for an executor whose groups all run
    the eager megastep."""
    return None


class _Side:
    """One executor, its KV manager and requests of the three apps, rid i
    of app ``APPS[i % 3]`` with a prompt of 6-19 tokens, all prefilled."""

    def __init__(self, zoo, n=14, graphs=True, device="cpu",
                 attn_impl="auto"):
        hops = max(sum(b.has_kv for b, _ in _steps(zoo, a)) for a in APPS)
        self.kv = KVManager(PAGE, 1 + n * hops * WIDTH, dtype=DTYPE,
                            device=device)
        self.ex = BlockExecutor(attn_impl=attn_impl, device=device,
                                compute_dtype=DTYPE, table_width=WIDTH,
                                max_lanes=16)
        if not graphs:
            self.ex._free_graph = _bind_nothing
        rng = np.random.RandomState(0)
        self.states = []
        for rid in range(n):
            app = APPS[rid % 3]
            steps = _steps(zoo, app)
            p = rng.randint(0, VOCAB, size=int(rng.randint(6, 20))).astype(
                np.int32)
            s = _State(rid=rid, app=app, steps=steps, prompt_tokens=p,
                       prompt_len=len(p))
            for i, (block, _) in enumerate(steps):
                if block.has_kv:
                    self.kv.pool_for(block)[1].alloc(rid, i, MAX_LEN)
            self.states.append(s)
        self.ex.prefill_batched(self.states, self.kv)

    def group(self, rids):
        return [self.states[r] for r in rids]

    def step(self, groups):
        """One engine step's decode: retire what re-formed, then one
        plain fused step per group."""
        self.ex.retire_states(keep=frozenset(tuple(g) for g in groups))
        for g in groups:
            self.ex.fused_step(self.group(g), self.kv)

    def lanes(self):
        """rid -> (pending token, kv length), from the device where the
        request's group keeps them."""
        out = {s.rid: (s.next_token, s.kv_len) for s in self.states}
        for ds in self.ex.decode_states.values():
            for i, rid in enumerate(ds.rids):
                out[rid] = (int(ds.next_token[i]), int(ds.kv_len[i]))
        return out

    def count(self, name):
        return self.ex.metrics.counter(name).value

    def slabs(self):
        return [t for p in self.kv.pools.values()
                for t in (p.k_pages, p.v_pages)]


def _per_app(g, side):
    """The group's lanes as one group per app, in first-seen order."""
    by_app = {}
    for r in g:
        by_app.setdefault(side.states[r].app, []).append(r)
    return list(by_app.values())


class _HopSide(_Side):
    """The per-hop oracle over the same requests: the engine's
    ``_run_hops`` on this side's executor and pools."""

    def __init__(self, zoo, **kw):
        super().__init__(zoo, graphs=False, **kw)
        self.engine = BlockEngine(zoo, max_len=MAX_LEN, config=EngineConfig(
            device="cpu", compute_dtype="bfloat16", page_size=PAGE,
            fused=False))
        self.engine.executor, self.engine.kv = self.ex, self.kv

    def step(self, groups):
        for g in groups:
            states = self.group(g)
            for s in states:
                s.tokens.append(s.next_token)
            self.engine._run_hops(states)


def _assert_same_pages(a, b):
    """Every page but the trash page holds the same K/V."""
    for x, y in zip(a.slabs(), b.slabs()):
        keep = torch.ones(x.shape[0], dtype=torch.bool)
        keep[TRASH_PAGE] = False
        assert torch.equal(x[keep], y[keep])


def test_merged_megastep_matches_each_apps_megastep_and_per_hop(zoo):
    """Over eight steps through three re-forms and two buckets, with lanes
    of the three apps interleaved and ragged contexts, the merged
    megastep (padded to its bucket) gives each app's own megastep's and
    the per-hop path's tokens, kv lengths and pages, bitwise, and each
    app's megastep's probabilities; pad lanes write only the trash page
    and stay at kv length 0."""
    merged, own, hop = _Side(zoo), _Side(zoo, graphs=False), _HopSide(zoo)
    for g in SCHEDULE:
        merged.step([g])
        own.step(_per_app(g, own))
        hop.step([g])
        want = own.lanes()
        assert merged.lanes() == want == hop.lanes()
        _assert_same_pages(merged, own)
        _assert_same_pages(merged, hop)
        ds = merged.ex.decode_states[tuple(g)]
        B, buf = len(g), ds.graph
        assert ds.sig[0] == "merged" and buf.lanes == _bucket(B)
        assert buf.kv_len[B:].eq(0).all() and buf.live[B:].eq(0).all()
        assert buf.lane_chain[:B].tolist() == [
            ds.sig[1].index(chain_signature(merged.states[r].steps))
            for r in g]
        for t in buf.tables:
            assert t[B:].eq(TRASH_PAGE).all()
        for sub in _per_app(g, own):
            rows = [g.index(r) for r in sub]
            assert torch.equal(ds.probs[rows],
                               own.ex.decode_states[tuple(sub)].probs)
    merged.ex.retire_states()
    own.ex.retire_states()
    for a, b, c in zip(merged.states, own.states, hop.states):
        assert a.tokens == b.tokens == c.tokens
        assert a.kv_len == b.kv_len == c.kv_len
        np.testing.assert_array_equal(a.probs_last, b.probs_last)
    lanes = sum(len(g) for g in SCHEDULE)
    assert merged.count("merged_lanes") == merged.count("fused_lanes") \
        == lanes
    assert merged.count("group_calls") == len(SCHEDULE)
    assert own.count("merged_lanes") == 0
    assert own.count("fused_lanes") == lanes
    # one capture per bucket: the buckets share the key, whatever the
    # lanes' mix of apps
    assert merged.count("graph_captures") == 2
    assert merged.count("graph_replays") == len(SCHEDULE) - 2


def test_one_chain_group_runs_its_own_megastep(zoo, monkeypatch):
    """A group of one app's lanes runs that chain's megastep, as before
    the merged walk: keyed by its signature, no lane-chain row in its
    graph, no merged lane counted, and the walk never given a merged
    plan."""
    walked = []
    real = executor_module.chain_decode_fused

    def chain_decode_fused(steps, *a, **k):
        walked.append(isinstance(steps, MergedChains))
        return real(steps, *a, **k)

    monkeypatch.setattr(executor_module, "chain_decode_fused",
                        chain_decode_fused)
    side = _Side(zoo)
    for g in ([0, 3, 6, 9], [0, 3, 6, 9], [1, 4, 7]):
        side.step([g])
        ds = side.ex.decode_states[tuple(g)]
        assert ds.sig == chain_signature(side.states[g[0]].steps)
        assert ds.lane_chain is None and ds.graph.lane_chain is None
        hops = len(ds.graph.tables)
        assert ds.graph.ints.numel() == (hops * WIDTH + 3) * ds.graph.lanes
    assert walked and not any(walked)
    assert side.count("merged_lanes") == 0
    assert side.count("fused_lanes") == 11


def test_merged_calls_count_the_launches_they_issue(zoo, monkeypatch):
    """``attn_calls`` and ``lora_calls`` count the paged and LoRA calls a
    merged walk issues (the kernels' plain versions here): one paged
    call an attention position over every lane, and one LoRA projection
    per LoRA weight set at each q and v, fewer than the apps' own
    megasteps issue together."""
    from repro_torch.core import blocks
    from repro_torch.kernels.paged_attention import ops

    calls = {"paged": 0, "lora": 0}

    def counted(fn, name):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ops, "paged_decode_step",
                        counted(ops.paged_decode_step, "paged"))
    monkeypatch.setattr(blocks, "batched_lora",
                        counted(blocks.batched_lora, "lora"))
    n_attn = sum(b.has_kv for b, _ in _steps(zoo, "base"))
    for merge in (True, False):
        side = _Side(zoo, attn_impl="ref", graphs=False)
        for name in calls:
            calls[name] = 0
        before = [side.count(c) for c in ("attn_calls", "lora_calls")]
        g = list(range(9))
        for _ in range(3):
            side.step([g] if merge else _per_app(g, side))
        assert side.count("attn_calls") - before[0] == calls["paged"]
        assert side.count("lora_calls") - before[1] == calls["lora"]
        assert calls["paged"] == 3 * n_attn * (1 if merge else 3)
        assert calls["lora"] == 3 * 2 * n_attn


def test_merge_sets_take_aligned_chains_that_share_weights(zoo, trees):
    """The three demo apps' chains merge (vicuna's own layer and
    app-lora's split halves align with the foundation's layers); a chain
    with BitFit adapters, and a foundation that shares no tensor with
    them, keep their own megasteps; a chain alone is no set."""
    from test_torch_blocks import port_zoo

    from repro_torch.configs import get_config
    from repro_torch.core.peft import create_bitfit
    from repro_torch.tree import tree_map

    base, ft, pefts = trees
    bitfit = create_bitfit(get_config("blockllm-demo"),
                           torch.Generator().manual_seed(0))
    other = port_zoo(tree_map(lambda x: x + 1.0, base), ft,
                     dict(pefts, bitfit=bitfit))
    chains = [(chain_signature(s), s) for s in (
        [_steps(zoo, a) for a in APPS]
        + [_steps(other, "app-bitfit"), _steps(other, "base")])]
    ex = BlockExecutor(device="cpu", table_width=WIDTH, max_lanes=16)
    sigs = [sig for sig, _ in chains]
    assert ex.merge_sets(chains) == [tuple(sigs[:3])]
    assert ex.merge_sets(chains[:1]) == []
    assert ex.merge_sets([chains[0], chains[4]]) == []
    assert ex.merge_sets(chains[1:3]) == [tuple(sigs[1:3])]


def _engine(zoo, **kw):
    return BlockEngine(zoo, max_len=MAX_LEN, config=EngineConfig(
        device="cpu", compute_dtype="bfloat16", page_size=PAGE, **kw))


def _requests(apps, n=6, seed=5, gen_len=7):
    rng = np.random.RandomState(seed)
    return [ServeRequest(app=apps[i % len(apps)], gen_len=gen_len,
                         prompt_tokens=rng.randint(
                             0, VOCAB, size=int(rng.randint(8, 20)))
                         .astype(np.int32)) for i in range(n)]


def _serve(engine, reqs):
    rids = [engine.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                       prompt_tokens=r.prompt_tokens))
            for r in reqs]
    out = {r.rid: r for r in engine.drain()}
    return [out[r] for r in rids]


@pytest.mark.parametrize("case", ["one_app", "per_hop", "speculation"])
def test_paths_without_merging_count_no_merged_lane(zoo, case):
    """One app's requests, the per-hop path and speculative steps run no
    merged walk: ``merged_lanes`` stays 0.  Speculative groups stay per
    chain even when the three apps are in flight."""
    if case == "one_app":
        e = _engine(zoo)
        _serve(e, _requests(("app-lora",)))
        assert e.stats["fused_lanes"] > 0
    elif case == "per_hop":
        e = _engine(zoo, fused=False)
        _serve(e, _requests(APPS))
        assert e.stats["fused_lanes"] == 0
    else:
        e = _engine(zoo, speculation=True, spec_prune_ratio=0.0,
                    spec_lookahead=3)
        inner = e.executor.spec_step
        sigs = []

        def spec_step(states, *a, **k):
            sigs.append({chain_signature(s.steps) for s in states})
            return inner(states, *a, **k)

        e.executor.spec_step = spec_step
        merged = e.executor.metrics.counter("merged_lanes")
        got = _serve(e, _requests(APPS, gen_len=12))
        want = _serve(_engine(zoo), _requests(APPS, gen_len=12))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.tokens, b.tokens)
        assert sigs and all(len(s) == 1 for s in sigs)
        assert e.stats["spec_attempts"] > 0
        # the plain steps of a lane's last tokens may merge; no spec step
        assert merged.value <= e.stats["fused_lanes"]
        return
    assert e.stats["merged_lanes"] == 0


def test_engine_merges_the_apps_in_flight(zoo):
    """With the three apps in flight the engine's plain lanes run merged:
    one group call a step while every request decodes, and the per-hop
    path's tokens."""
    reqs = _requests(APPS, n=9, gen_len=6)
    e = _engine(zoo, max_active=9)
    got = _serve(e, reqs)
    want = _serve(_engine(zoo, fused=False), reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    st = e.stats
    assert st["merged_lanes"] == st["fused_lanes"] == st["decode_tokens"]
    assert st["group_calls"] == st["steps"] - 1  # the last step finishes


# ---------------------------------------------------------------------------
# on the card: the merged megastep captured and replayed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_zoo():
    """The demo zoo on the card, app-lora with nonzero B matrices (the
    recipe starts them at zero, which makes app-lora the base model)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.core import peft
    from repro_torch.serving.demo import build_demo_zoo

    cfg, _, zoo = build_demo_zoo(0, device="cuda")
    lora = peft.create_lora(cfg, torch.Generator("cuda").manual_seed(2))
    g = torch.Generator("cuda").manual_seed(100)
    for layer in lora:
        layer["b_q"].normal_(0.0, 0.05, generator=g)
        layer["b_v"].normal_(0.0, 0.05, generator=g)
    zoo.register_peft("app-lora", cfg, "base", "lora", lora)
    return zoo


def _card_sides(zoo):
    """Two executors over pools prefilled alike on the card: one that
    captures and replays its merged megastep graphs, one that runs the
    same padded merged megastep over the same buffers eagerly."""
    graph = _Side(zoo, device="cuda")
    eager = _Side(zoo, device="cuda")

    def first_call(g, fn, pk, pv):
        eager.ex._run_static(g, fn, pk, pv)
        g.ready = True

    eager.ex._capture = first_call
    return graph, eager


@pytest.mark.cuda
def test_merged_replay_matches_the_merged_eager_megastep(card_zoo):
    """Replays of the captured merged megastep equal the same padded
    merged megastep issued eagerly, bitwise in tokens, probabilities, kv
    lengths and every page, the trash page included, through re-forms and
    a second bucket; the kernel modules' launch counters advance alike on
    both sides and as the engine's counters say."""
    from repro_torch.kernels.batched_lora import kernel as lora_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel

    def launched(side, g):
        before = (pa_kernel.launches, lora_kernel.launches,
                  side.count("attn_calls"), side.count("lora_calls"))
        side.step([g])
        return (pa_kernel.launches - before[0],
                lora_kernel.launches - before[1],
                side.count("attn_calls") - before[2],
                side.count("lora_calls") - before[3])

    graph, eager = _card_sides(card_zoo)
    for g in SCHEDULE:
        got, want = launched(graph, g), launched(eager, g)
        assert got == want and got[:2] == got[2:] and min(got) > 0
        torch.cuda.synchronize()
        a = graph.ex.decode_states[tuple(g)]
        b = eager.ex.decode_states[tuple(g)]
        for name in ("next_token", "kv_len", "probs"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        for x, y in zip(graph.slabs(), eager.slabs()):
            assert torch.equal(x, y)
        assert a.graph.graph is not None and b.graph.graph is None
    graph.ex.retire_states()
    eager.ex.retire_states()
    for a, b in zip(graph.states, eager.states):
        assert a.tokens == b.tokens and a.kv_len == b.kv_len
    assert (graph.count("graph_captures"), graph.count("graph_replays")) \
        == (2, len(SCHEDULE) - 2)
    assert graph.count("merged_lanes") == sum(len(g) for g in SCHEDULE)


@pytest.mark.cuda
def test_steady_merged_replay_holds_no_sync(card_zoo):
    """A bound merged group's replayed steps issue no host
    synchronisation."""
    side = _Side(card_zoo, device="cuda")
    g = list(range(9))
    side.step([g])
    torch.cuda.synchronize()
    states = side.group(g)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            side.ex.fused_step(states, side.kv)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert side.count("graph_replays") == 3
    assert side.count("merged_lanes") == 4 * len(g)
