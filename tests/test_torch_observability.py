"""The port's step spans and their counters (``repro_torch.observability``):
every engine step is one root ``engine.step`` span whose children
(admission, prefill calls, retirement, finishing, one megastep per group
call, and the waits inside them) nest on one clock; the counters the
benchmark reads are the sums of those spans; the ring keeps its bound; the
Chrome export carries ids, parents and the clock anchor.

The CPU tests serve the demo zoo on the CPU.  The two ``cuda`` tests run on
the card: a steady-state megastep holds no hidden host sync, and a span
lines up with the device trace of ``torch.profiler`` through the anchor.
This file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_observability.py
"""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.observability import MetricsRegistry, Tracer, trace
from repro_torch.observability.trace import clock_anchor, self_ns
from repro_torch.serving.api import ServeRequest
from repro_torch.serving.engine import BlockEngine, EngineConfig
from repro_torch.serving.executor import _bucket

APPS = ("base", "vicuna", "app-lora")
CHILDREN = {"engine.admit", "executor.prefill", "executor.retire",
            "engine.finish", "executor.megastep"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def zoo():
    from repro_torch.serving.demo import build_demo_zoo

    return build_demo_zoo(0, device="cpu")[2]


def _requests(n=7, seed=3, gen=(4, 9, 6)):
    rng = np.random.RandomState(seed)
    return [ServeRequest(app=APPS[i % 3], gen_len=gen[i % len(gen)],
                         prompt_tokens=rng.randint(
                             0, 512, size=int(rng.randint(5, 40))).astype(
                                 np.int32)) for i in range(n)]


def _serve(engine, reqs, late=2):
    """Submit all but ``late`` requests, step, then the rest mid-flight;
    returns (results by rid, number of ``step()`` calls that did work)."""
    for r in reqs[:len(reqs) - late]:
        engine.submit(r)
    out, calls = {}, 0
    while True:
        if calls == 2:
            for r in reqs[len(reqs) - late:]:
                engine.submit(r)
        res = engine.step()
        if res is None:
            return out, calls
        calls += 1
        out.update((x.rid, x) for x in res)


def _engine(zoo, **kw):
    return BlockEngine(zoo, max_len=64, config=EngineConfig(
        device="cpu", compute_dtype="float32", **kw))


CASES = {"fused": {}, "per_hop": {"fused": False},
         "speculation": {"speculation": True, "spec_min_fidelity": 0.0,
                         "spec_min_accept": 0.0}}


@pytest.fixture(scope="module", params=list(CASES))
def served(request, zoo):
    engine = _engine(zoo, **CASES[request.param])
    reqs = _requests()
    out, calls = _serve(engine, reqs)
    return request.param, engine, reqs, out, calls


def test_one_root_step_span_per_working_step(served):
    _, engine, _, _, calls = served
    spans = list(engine.tracer.spans)
    roots = [s for s in spans if s[1] is None]
    assert {s[2] for s in roots} == {"engine.step"}
    working = [s for s in roots if "step" in s[5]]
    assert len(working) == calls == engine.stats["steps"]
    assert [s[5]["step"] for s in working] == list(range(1, calls + 1))
    # the one idle call of drain() is a root with no work noted
    assert len(roots) == calls + 1


def test_children_nest_inside_their_parents(served):
    case, engine, _, _, _ = served
    spans = {s[0]: s for s in engine.tracer.spans}
    names = {s[2] for s in spans.values()}
    for sid, parent, name, t0, t1, _ in spans.values():
        assert t1 >= t0
        if parent is None:
            continue
        p = spans[parent]  # every parent id resolves
        assert p[3] <= t0 and t1 <= p[4], (name, p[2])
        if name in CHILDREN:
            assert p[2] in ("engine.step", "engine.admit"), (name, p[2])
        else:
            assert name == "executor.wait"
    assert all(v >= 0 for v in self_ns(spans.values()).values())
    assert {"engine.step", "engine.admit", "executor.prefill",
            "executor.retire", "engine.finish", "executor.wait"} <= names
    assert ("executor.megastep" in names) == (case != "per_hop")


def test_counters_are_the_sums_of_their_spans(served):
    case, engine, reqs, _, _ = served
    by = {}
    for _, _, name, t0, t1, attrs in engine.tracer.spans:
        by.setdefault(name, []).append((t1 - t0, attrs))
    st = engine.stats
    for counter, name in (("dispatch_ns", "executor.megastep"),
                          ("host_wait_ns", "executor.wait"),
                          ("prefill_ns", "executor.prefill")):
        assert st[counter] == sum(d for d, _ in by.get(name, []))
    assert st["host_wait_ns"] > 0 and st["prefill_ns"] > 0
    lens = [r.prompt_len for r in reqs]
    assert st["prefill_tokens"] == sum(lens)
    padded = sum(lens) if case == "per_hop" else sum(_bucket(n)
                                                     for n in lens)
    assert st["prefill_padded_tokens"] == padded
    prefills = [a for _, a in by["executor.prefill"]]
    assert sum(a["tokens"] for a in prefills) == sum(lens)
    assert sum(a["padded"] for a in prefills) == padded
    assert sorted(r for a in prefills for r in a["rids"]) == \
        list(range(len(reqs)))
    if case == "speculation":
        assert st["spec_attempts"] > 0
    if case != "per_hop":
        assert len(by["executor.megastep"]) == st["group_calls"]
        assert sum(a["B"] for _, a in by["executor.megastep"]) > 0


def test_no_decode_step_instants_and_phase_spans_unchanged(served):
    _, engine, reqs, out, _ = served
    assert sorted(out) == list(range(len(reqs)))
    for rid, res in out.items():
        tr = res.info["trace"]
        assert not any(e["name"] == "decode_step" for e in tr["events"])
        spans = tr["spans"]
        assert [s["name"] for s in spans] == ["queued", "prefill", "decode"]
        for a, b in zip(spans, spans[1:]):
            assert a["t1"] == b["t0"]
        assert spans[-1]["t1"] == res.info["t_finish"]
        assert len(res.tokens) == reqs[rid].gen_len


def test_recalc_prefill_is_counted_unpadded(zoo):
    """A recompute readmission prefills its prompt through ``prefill()``:
    one more span, its tokens counted as run (no bucket)."""
    engine = _engine(zoo)
    reqs = _requests(3, seed=11, gen=(8,))
    rids = [engine.submit(r) for r in reqs]
    engine.step()
    engine.step()
    assert engine.preempt(rids[1], strategy="recalc")
    engine.drain()
    lens = [r.prompt_len for r in reqs]
    st = engine.stats
    assert st["prefill_tokens"] == sum(lens) + lens[1]
    assert st["prefill_padded_tokens"] == \
        sum(_bucket(n) for n in lens) + lens[1]
    recalc = [s for s in engine.tracer.spans if s[2] == "executor.prefill"
              and s[5]["rids"] == [rids[1]] and s[5]["bucket"] == lens[1]]
    assert len(recalc) == 1


def test_span_parents_notes_and_counter():
    tr, c = Tracer(), MetricsRegistry().counter("x_ns")
    with tr.span("a", k=1) as a:
        with tr.span("b", add_to=c) as b:
            tr.note(a, late=2)
        with tr.span("c", parent=b):
            pass
    with pytest.raises(KeyError):
        tr.note(a, late=3)
    recs = {s[2]: s for s in tr.spans}
    assert recs["a"][1] is None and recs["b"][1] == a and recs["c"][1] == b
    assert recs["a"][5] == {"k": 1, "late": 2}
    assert c.value == recs["b"][4] - recs["b"][3]
    # a span closed by an exception is still recorded
    with pytest.raises(ValueError):
        with tr.span("d"):
            raise ValueError
    assert tr.spans[-1][2] == "d" and not tr._open


def test_self_ns():
    spans = [(2, 1, "child", 10, 40, {}), (3, 1, "child", 50, 60, {}),
             (4, 2, "grandchild", 15, 35, {}), (1, None, "root", 0, 100, {})]
    assert self_ns(spans) == {1: 60, 2: 10, 3: 10, 4: 20}


def test_span_ring_keeps_its_bound(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 8)
    tr = Tracer()
    for i in range(20):
        with tr.span("s", i=i):
            pass
    assert len(tr.spans) == 8
    assert [s[5]["i"] for s in tr.spans] == list(range(12, 20))


def test_clock_anchor_maps_onto_the_unix_clock():
    for p, unix in (clock_anchor(), Tracer().anchor):
        now = time.perf_counter_ns() - p + unix
        assert abs(now - time.time_ns()) < 50_000_000


def test_chrome_export_carries_ids_parents_and_anchor(served, tmp_path):
    _, engine, reqs, _, _ = served
    path = tmp_path / "trace.json"
    engine.write_trace(str(path))
    doc = json.loads(path.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    eng = [e for e in xs if e["tid"] == 0]
    assert len(eng) == len(engine.tracer.spans)
    ids = {e["args"]["id"] for e in eng}
    for e in eng:
        assert "id" in e["args"] and "parent" in e["args"]
        assert e["args"]["parent"] is None or e["args"]["parent"] in ids
        assert e["dur"] >= 0
    by_id = {e["args"]["id"]: e for e in eng}
    for e in eng:
        if e["args"]["parent"] is not None:
            p = by_id[e["args"]["parent"]]
            assert p["ts"] - 1e-3 <= e["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    other = doc["otherData"]
    assert len(other["clock_anchors"]) == 2
    for a in other["clock_anchors"]:
        assert isinstance(a["perf_counter_ns"], int)
        assert isinstance(a["time_ns"], int)
    # a span's ts maps back onto its perf_counter_ns start
    first = min(engine.tracer.spans, key=lambda s: s[3])
    ev = by_id[first[0]]
    assert abs(ev["ts"] * 1e3 + other["ts_zero_perf_counter_ns"]
               - first[3]) < 1e3
    # the request tracks keep their phase spans
    phases = {e["name"] for e in xs if e["tid"] > 0}
    assert phases == {"queued", "prefill", "decode"}
    assert {e["tid"] for e in xs if e["tid"] > 0} == \
        set(range(1, len(reqs) + 1))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_steady_megastep_holds_no_hidden_sync(card):
    """A fused step of a group whose decode state already lives on the
    device, inside its dispatch span, issues no host synchronisation."""
    from repro_torch.serving.demo import build_demo_zoo

    zoo = build_demo_zoo(0, device="cuda")[2]
    engine = BlockEngine(zoo, max_len=64, config=EngineConfig(
        device="cuda", compute_dtype="bfloat16"))
    for r in _requests(6, gen=(20,)):
        engine.submit(r)
    for _ in range(3):
        engine.step()
    ex = engine.executor
    assert ex.decode_states
    for ds in list(ex.decode_states.values()):
        ex.fused_step(ds.states, engine.kv)  # every state stepped once
    torch.cuda.synchronize()
    before = engine.stats["dispatch_ns"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ds in list(ex.decode_states.values()):
            with engine.tracer.span("executor.megastep",
                                    add_to=engine._c_dispatch_ns,
                                    B=len(ds.states)):
                ex.fused_step(ds.states, engine.kv)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert engine.stats["dispatch_ns"] > before


@pytest.mark.cuda
def test_span_lines_up_with_the_profiler_through_the_anchor(card):
    """A span around one launch, after a synchronise, starts 0-100 us
    before that kernel's absolute start in the device trace.  A profiling
    session's first launches set up its tracing and start late, so a few
    launches go before the measured ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device=card)
    x.add_(1)
    torch.cuda.synchronize()
    tr, n = Tracer(), 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            x.add_(1)
        for _ in range(n):
            torch.cuda.synchronize()
            with tr.span("launch"):
                x.add_(1)
            torch.cuda.synchronize()
    anchor = clock_anchor()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted(ev.time_range.start for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA)
    assert len(kernels) == 5 + n
    gaps = [start_ns + k * 1e3 - (s[3] - anchor[0] + anchor[1])
            for k, s in zip(kernels[5:], tr.spans)]
    print("span start to kernel start, us:", [round(g / 1e3, 1)
                                              for g in gaps])
    assert all(0 <= g <= 100_000 for g in gaps), gaps
