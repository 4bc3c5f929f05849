"""The readers of the megastep graphs' counters, and a fault on the
padded megastep's real lanes.

Each reader divides window deltas of the engine's own counters and reads
nothing (None) from a program that keeps no such counter, made no group
call or replayed nothing.  The fused megastep runs a group at its lane
bucket, a power of two of at least 8 or ``max_block_batch`` where that
is fewer, so the lanes past a small group's size are padding: a fault
must touch the real lanes (kv length above 0; a pad lane's stays 0) to
be a fault of the served requests."""
import math
import time

import pytest
import torch

from repro_torch.serving import executor
from servebench import harness
from servebench.drivers import engine as driver
from servebench.tests import _tiny
from servebench.tests.test_sb_faults import REAL_DECODE, _config
from servebench.traffic import gen

NAMES = ("executor.graph_replay_share", "executor.graph_pad_share")
COUNTERS = {"steps": 40, "group_calls": 120, "graph_replays": 114,
            "graph_captures": 2, "graph_lanes": 3_648,
            "graph_real_lanes": 2_736}
WANT = {"executor.graph_replay_share": 95.0,
        "executor.graph_pad_share": 25.0}
NEEDS = {"executor.graph_replay_share": ("graph_replays", "group_calls"),
         "executor.graph_pad_share": ("graph_lanes", "graph_real_lanes")}
ZERO = {"executor.graph_replay_share": "group_calls",
        "executor.graph_pad_share": "graph_lanes"}


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_the_hand_computed_value(name):
    got = harness.load_reader(name).read({"counters": dict(COUNTERS)})
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_nothing_without_its_counters(name):
    read = harness.load_reader(name).read
    for key in NEEDS[name]:
        c = dict(COUNTERS)
        del c[key]
        assert read({"counters": c}) is None
    # the parent's program: the step-span counters, no graph counters
    assert read({"counters": {"steps": 40, "group_calls": 120,
                              "dispatch_ns": 6_000_000_000}}) is None
    assert read({"counters": dict(COUNTERS, **{ZERO[name]: 0})}) is None
    assert read({}) is None


def test_readers_read_a_tiny_cpu_run():
    cfg, mix = _tiny.config(), _tiny.mix()
    seed = 3141592653589
    reqs = gen.generate(mix, seed, float(mix["preroll_s"]) + 3.0,
                        cfg["model"]["vocab_size"])
    session = driver.Session(cfg, mix, seed, "cpu")
    session.warm(reqs)
    rec = session.run(reqs, 3.0, time.perf_counter())
    session.close()
    c = rec["counters"]
    assert c["group_calls"] > 0 and c["graph_replays"] > 0
    share = harness.load_reader("executor.graph_replay_share").read(rec)
    pad = harness.load_reader("executor.graph_pad_share").read(rec)
    assert math.isfinite(share) and 0 < share <= 100
    # max_block_batch 4: every group runs at 4 lanes
    assert c["graph_lanes"] == 4 * c["graph_replays"]
    assert pad == pytest.approx(
        100 * (1 - c["graph_real_lanes"] / c["graph_lanes"]), rel=1e-12)
    assert 0 <= pad < 75


def _half_of_real_lanes_left_out(*a, **k):
    """Half of the group's real lanes take its first real lane's token."""
    nxt, probs, pk, pv, kv = REAL_DECODE(*a, **k)
    real = torch.nonzero(a[6] > 0).flatten()
    nxt = nxt.clone()
    nxt[real[len(real) // 2:]] = nxt[real[0]].clone()
    return nxt, probs, pk, pv, kv


def test_fault_on_the_real_lanes_is_caught(monkeypatch):
    monkeypatch.setattr(executor, "chain_decode_fused",
                        _half_of_real_lanes_left_out)
    out = _tiny.run(cfg=_config(), mix=_tiny.mix(), seconds=2.5)
    assert out["sample"]["positions"] >= 60
    c = out["checks"]["widest_gap"]
    assert not out["correct"], c
    assert c["value"] > c["limit"]
