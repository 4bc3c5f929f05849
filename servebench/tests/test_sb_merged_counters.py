"""The reader of the merged megastep's counters.

``executor.merged_lane_share`` divides window deltas of the engine's own
counters, ``merged_lanes`` (real lanes of the plain fused calls that
walked the lanes of more than one chain) over ``fused_lanes`` (real lanes
of every plain fused call), and reads nothing (None) from a program that
keeps no such counter or ran no plain fused lane."""
import math
import time

import pytest

from servebench import harness
from servebench.drivers import engine as driver
from servebench.tests import _tiny
from servebench.traffic import gen

NAME = "executor.merged_lane_share"
COUNTERS = {"steps": 40, "group_calls": 48, "graph_replays": 46,
            "fused_lanes": 2_560, "merged_lanes": 2_432}


def test_reader_gives_the_hand_computed_value():
    got = harness.load_reader(NAME).read({"counters": dict(COUNTERS)})
    assert got == pytest.approx(95.0, rel=1e-12)


@pytest.mark.parametrize("missing", ["fused_lanes", "merged_lanes"])
def test_reader_reads_nothing_without_its_counters(missing):
    read = harness.load_reader(NAME).read
    c = dict(COUNTERS)
    del c[missing]
    assert read({"counters": c}) is None
    # the parent's program: the graph counters, no merged-walk counters
    assert read({"counters": {"steps": 40, "group_calls": 120,
                              "graph_replays": 114}}) is None
    assert read({"counters": dict(COUNTERS, fused_lanes=0)}) is None
    assert read({}) is None


def test_reader_reads_a_tiny_cpu_run():
    """The tiny cell's zoo serves its three apps, whose chains share the
    foundation's blocks: their plain lanes run merged walks."""
    cfg, mix = _tiny.config(), _tiny.mix()
    seed = 1414213562373
    reqs = gen.generate(mix, seed, float(mix["preroll_s"]) + 3.0,
                        cfg["model"]["vocab_size"])
    assert len({r.app for r in reqs}) == 3
    session = driver.Session(cfg, mix, seed, "cpu")
    session.warm(reqs)
    rec = session.run(reqs, 3.0, time.perf_counter())
    session.close()
    c = rec["counters"]
    assert 0 < c["merged_lanes"] <= c["fused_lanes"]
    share = harness.load_reader(NAME).read(rec)
    assert math.isfinite(share) and 0 < share <= 100
    assert share == pytest.approx(
        100 * c["merged_lanes"] / c["fused_lanes"], rel=1e-12)
