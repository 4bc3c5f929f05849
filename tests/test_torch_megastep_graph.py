"""Megastep graphs (``serving/executor.py``): a fused group's megastep run
over the padded static buffers of its (chain signature, lane bucket)
against the unpadded eager megastep, on the CPU, where a replay calls the
megastep on the buffers.

Each test drives two executors over two KV managers prefilled alike: one
with megastep graphs, one that runs every group eagerly (its
``_free_graph`` binds nothing: the megastep as it was before graphs).
The real lanes' tokens, probabilities, kv lengths and K/V pages must
agree bitwise; pad lanes may write only the trash page.

The comparisons run in bf16, the type the port serves in.  The CPU's
fp32 kernels do not keep a row's bits when the batch grows: an
elementwise pass treats the last elements of a buffer apart (silu of
3 x 688 fp32 values differs from the first three rows of 8 x 688 by up
to 1.5e-8), and the GEMM takes another path at one row.  PERF.md records
what cuBLAS does on the card.
"""
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import pytest
import torch

from repro_torch.serving.api import ServeRequest
from repro_torch.serving.engine import BlockEngine, EngineConfig
from repro_torch.serving.executor import BlockExecutor
from repro_torch.serving.kv_pool import TRASH_PAGE, KVManager

DTYPE = "bfloat16"
PAGE, MAX_LEN = 4, 64
WIDTH = MAX_LEN // PAGE
VOCAB = 512
COUNTERS = ("group_calls", "graph_replays", "graph_captures", "graph_lanes",
            "graph_real_lanes")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def zoo():
    from test_torch_blocks import jax_demo_trees, port_zoo

    return port_zoo(*jax_demo_trees())


@dataclass
class _State:
    """A request's state as the executor reads it (the engine's
    ``_ReqState``, duck-typed)."""
    rid: int
    app: str
    steps: list
    prompt_tokens: np.ndarray
    prompt_len: int
    kv_len: int = 0
    next_token: Optional[int] = None
    probs_last: Optional[np.ndarray] = None
    tokens: List[int] = field(default_factory=list)


def _steps(zoo, app):
    return [(zoo.blocks[s.block_id],
             tuple(zoo.blocks[a] for a in s.adapter_ids))
            for s in zoo.chains[app].steps]


class _Side:
    """One executor, its KV manager and its request states."""

    def __init__(self, zoo, app, dtype, n, slot, graphs=True, seed=0,
                 device="cpu", max_lanes=16):
        self.dtype = getattr(torch, dtype)
        steps = _steps(zoo, app)
        hops = sum(b.has_kv for b, _ in steps)
        self.kv = KVManager(PAGE, 1 + n * hops * -(-slot // PAGE),
                            dtype=self.dtype, device=device)
        self.ex = BlockExecutor(device=device, compute_dtype=self.dtype,
                                table_width=WIDTH, max_lanes=max_lanes)
        if not graphs:
            self.ex._free_graph = _bind_nothing
        rng = np.random.RandomState(seed)
        self.states = []
        for rid in range(n):
            p = rng.randint(0, VOCAB, size=int(rng.randint(6, 20))).astype(
                np.int32)
            s = _State(rid=rid, app=app, steps=steps, prompt_tokens=p,
                       prompt_len=len(p))
            for i, (block, _) in enumerate(steps):
                if block.has_kv:
                    self.kv.pool_for(block)[1].alloc(rid, i, slot)
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

    def counters(self):
        return {c: self.ex.metrics.counter(c).value for c in COUNTERS}

    def slabs(self):
        return [t for p in self.kv.pools.values()
                for t in (p.k_pages, p.v_pages)]


def _bind_nothing(*args):
    """``BlockExecutor._free_graph`` for an executor whose groups all run
    the eager megastep."""
    return None


def _pair(zoo, app, dtype, n, slot=MAX_LEN, max_lanes=16):
    return (_Side(zoo, app, dtype, n, slot, max_lanes=max_lanes),
            _Side(zoo, app, dtype, n, slot, graphs=False))


def _assert_same_state(graph, eager, groups):
    for g in groups:
        a = graph.ex.decode_states[tuple(g)]
        b = eager.ex.decode_states[tuple(g)]
        for name in ("next_token", "kv_len", "probs"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert a.buffered_counts == b.buffered_counts
    # every page but the trash page holds the same K/V: the real lanes
    # wrote the same values, and the pad lanes nothing else
    for x, y in zip(graph.slabs(), eager.slabs()):
        keep = torch.ones(x.shape[0], dtype=torch.bool)
        keep[TRASH_PAGE] = False
        assert torch.equal(x[keep], y[keep])


def _assert_same_host(graph, eager):
    for a, b in zip(graph.states, eager.states):
        assert a.tokens == b.tokens and a.kv_len == b.kv_len
        assert a.next_token == b.next_token
        np.testing.assert_array_equal(a.probs_last, b.probs_last)


# a lane that finishes (2 and 5), one that joins (6), then a move from
# bucket 8 to bucket 16 (7-11 join)
SCHEDULE = ([[0, 1, 2, 3, 4, 5]] * 2 + [[0, 1, 3, 4, 6]] * 2
            + [[0, 1, 3, 4, 6, 7, 8, 9, 10, 11]] * 3)
FIRST_CALLS = (0, 4)  # the steps that open a bucket


@pytest.mark.parametrize("app", ["base", "vicuna", "app-lora"])
def test_padded_megastep_matches_the_eager_one(zoo, app):
    """Over seven steps through a finish, a join and a move from bucket 8
    to 16, the padded megastep gives the eager one's tokens,
    probabilities, kv lengths and pages, bitwise; pad lanes write only
    the trash page and stay at kv length 0; retiring gives the same host
    states."""
    graph, eager = _pair(zoo, app, DTYPE, 12)
    for groups in [[g] for g in SCHEDULE]:
        graph.step(groups)
        eager.step(groups)
        _assert_same_state(graph, eager, groups)
        (g,) = groups
        ds = graph.ex.decode_states[tuple(g)]
        B, buf = len(g), ds.graph
        assert buf.lanes == (8 if B <= 8 else 16)
        assert buf.kv_len[B:].eq(0).all() and buf.live[B:].eq(0).all()
        assert buf.live[:B].eq(1).all()
        for t in buf.tables:
            assert t.shape == (buf.lanes, WIDTH)
            assert t[B:].eq(TRASH_PAGE).all()
    graph.ex.retire_states()
    eager.ex.retire_states()
    _assert_same_host(graph, eager)
    assert not graph.ex._bound
    assert all(not g.views for g in graph.ex.graphs.values())
    replayed = [g for i, g in enumerate(SCHEDULE) if i not in FIRST_CALLS]
    assert graph.counters() == {
        "group_calls": len(SCHEDULE), "graph_captures": len(FIRST_CALLS),
        "graph_replays": len(replayed),
        "graph_lanes": sum(8 if len(g) <= 8 else 16 for g in replayed),
        "graph_real_lanes": sum(len(g) for g in replayed)}
    assert eager.counters() == dict.fromkeys(COUNTERS, 0) | {
        "group_calls": len(SCHEDULE)}


@pytest.mark.parametrize("B", [3, 4])
def test_buckets_stop_at_max_lanes(zoo, B):
    """Groups are at most ``max_lanes`` wide, so no bucket is wider: under
    a cap of 4 a group of 3 or 4 runs 4 lanes, with the eager executor's
    results."""
    graph, eager = _pair(zoo, "vicuna", DTYPE, B, max_lanes=4)
    g = list(range(B))
    for _ in range(3):
        graph.step([g])
        eager.step([g])
        _assert_same_state(graph, eager, [g])
    assert graph.ex.decode_states[tuple(g)].graph.lanes == 4
    assert graph.counters() == {"group_calls": 3, "graph_captures": 1,
                                "graph_replays": 2, "graph_lanes": 8,
                                "graph_real_lanes": 2 * B}
    graph.ex.retire_states()
    eager.ex.retire_states()
    _assert_same_host(graph, eager)


# per case: the requests, the two groups, their counters after three
# steps, then the groups once the first retires and the graph counters
# after two more steps (None: no graph is ever bound)
UNBOUND = {
    # a second group of the bound bucket
    "second_group": (9, [[0, 1, 2], [3, 4, 5]],
                     dict(graph_captures=1, graph_replays=2, graph_lanes=16,
                          graph_real_lanes=6),
                     [[6, 7, 8], [3, 4, 5]],
                     dict(graph_captures=1, graph_replays=4)),
    # a second group of the signature at another bucket: the buckets share
    # the signature's probabilities buffer, bucket 16 opened first
    "second_bucket": (23, [list(range(16)), [16, 17, 18, 19]],
                      dict(graph_captures=1, graph_replays=2,
                           graph_lanes=32, graph_real_lanes=32),
                      [[20, 21, 22], [16, 17, 18, 19]],
                      dict(graph_captures=2, graph_replays=3)),
    # rows wider than the graphs' tables
    "row_past_the_width": (6, [[0, 1, 2], [3, 4, 5]], {}, None, None),
}


@pytest.mark.parametrize("case", list(UNBOUND))
def test_unbound_groups_run_eagerly(zoo, case):
    """A group of a signature another live group is bound to, whatever
    its bucket, or with a row wider than the graphs' tables, runs the
    eager megastep: counted as a group call and not as a replay, with the
    eager executor's results, the probabilities included.  Once the bound
    group retires, a new group of the signature is bound."""
    n, groups, counted, then, counted_then = UNBOUND[case]
    slot = MAX_LEN + 3 * PAGE if case == "row_past_the_width" else MAX_LEN
    graph, eager = _pair(zoo, "base", DTYPE, n, slot=slot)
    for _ in range(3):
        graph.step(groups)
        eager.step(groups)
        _assert_same_state(graph, eager, groups)
    ds = [graph.ex.decode_states[tuple(g)] for g in groups]
    assert graph.counters() == dict.fromkeys(COUNTERS, 0) | counted | {
        "group_calls": 6}
    assert ds[1].graph is None
    if then is None:
        assert ds[0].graph is None
        return
    assert ds[0].graph is not None
    for _ in range(2):
        graph.step(then)
        eager.step(then)
        _assert_same_state(graph, eager, then)
    assert graph.ex.decode_states[tuple(then[0])].graph is not None
    assert graph.ex.decode_states[tuple(then[1])].graph is None
    c = graph.counters()
    assert {k: c[k] for k in counted_then} == counted_then
    graph.ex.retire_states()
    eager.ex.retire_states()
    _assert_same_host(graph, eager)


def test_speculative_step_between_replays(zoo):
    """A bound group that takes a speculative step (eager, off the
    buffers) is staged back into them by its next plain step, with the
    eager executor's results throughout."""
    ratio, k = 0.0, 3
    steps = _steps(zoo, "base")
    sur = [(zoo.blocks[zoo.surrogate_for(b.id, ratio)]
            if "w_gate" in b.params else b, a) for b, a in steps]
    graph, eager = _pair(zoo, "base", DTYPE, 4, slot=MAX_LEN)
    g = [0, 1, 2, 3]
    for kind in ("plain", "spec", "plain", "plain", "spec", "plain"):
        for side in (graph, eager):
            if kind == "plain":
                side.step([g])
            else:
                side.ex.spec_step(side.group(g), side.kv, sur, k, [30] * 4)
        _assert_same_state(graph, eager, [g])
    assert graph.ex.decode_states[tuple(g)].graph is not None
    c = graph.counters()
    assert c["graph_captures"] == 1 and c["graph_replays"] == 3
    graph.ex.retire_states()
    eager.ex.retire_states()
    _assert_same_host(graph, eager)


def test_engine_serves_the_eager_tokens(zoo):
    """The engine with megastep graphs serves the tokens and final
    distributions of the same engine with its graphs off, over requests
    that finish and join at different steps; every fused call of the
    graphs' engine is a bucket's first call or a replay."""
    rng = np.random.RandomState(3)
    reqs = [ServeRequest(app=("base", "vicuna", "app-lora")[i % 3],
                         gen_len=int(rng.randint(3, 12)),
                         prompt_tokens=rng.randint(
                             0, VOCAB, size=int(rng.randint(6, 20)))
                         .astype(np.int32)) for i in range(18)]
    out = []
    for graphs in (True, False):
        e = BlockEngine(zoo, max_len=MAX_LEN, config=EngineConfig(
            device="cpu", compute_dtype=DTYPE, max_active=12,
            page_size=PAGE))
        if not graphs:
            e.executor._free_graph = _bind_nothing
        rids = [e.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                      prompt_tokens=r.prompt_tokens))
                for r in reqs[:9]]
        done = {r.rid: r for r in e.step()}
        rids += [e.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                       prompt_tokens=r.prompt_tokens))
                 for r in reqs[9:]]
        done.update({r.rid: r for r in e.drain()})
        out.append(([done[r] for r in rids], dict(e.stats)))
    (got, st), (want, st0) = out
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.probs_last, b.probs_last)
    assert st["graph_replays"] > st["graph_captures"] > 0
    assert st["graph_replays"] + st["graph_captures"] <= st["group_calls"]
    assert st["graph_lanes"] >= st["graph_real_lanes"] > 0
    assert st0["graph_replays"] == st0["graph_captures"] == 0
    assert st["decode_tokens"] == st0["decode_tokens"]
