"""The readers of the program's step-span counters: each divides window
deltas of the engine's own counters, and reads nothing (None) from a
program that keeps no such counter or did no step."""
import math
import time

import pytest

from servebench import harness
from servebench.drivers import engine as driver
from servebench.tests import _tiny
from servebench.traffic import gen

NAMES = ("executor.dispatch_ms_per_step", "executor.host_wait_ms_per_step",
         "executor.prefill_ms_per_ktok", "executor.prefill_pad_share")
COUNTERS = {"steps": 40, "dispatch_ns": 6_000_000_000,
            "host_wait_ns": 400_000_000, "prefill_ns": 900_000_000,
            "prefill_tokens": 9_000, "prefill_padded_tokens": 12_000}
WANT = {"executor.dispatch_ms_per_step": 150.0,
        "executor.host_wait_ms_per_step": 10.0,
        "executor.prefill_ms_per_ktok": 100.0,
        "executor.prefill_pad_share": 25.0}
NEEDS = {"executor.dispatch_ms_per_step": ("dispatch_ns",),
         "executor.host_wait_ms_per_step": ("host_wait_ns",),
         "executor.prefill_ms_per_ktok": ("prefill_ns", "prefill_tokens"),
         "executor.prefill_pad_share": ("prefill_tokens",
                                        "prefill_padded_tokens")}


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
    # a program without the step-span counters: only the older ones
    assert read({"counters": {"steps": 40, "group_calls": 120}}) is None
    assert read({"counters": dict(COUNTERS, steps=0)}) is None
    assert read({}) is None


def test_readers_read_a_tiny_cpu_run():
    cfg, mix = _tiny.config(), _tiny.mix()
    seed = 2718281828459
    reqs = gen.generate(mix, seed, float(mix["preroll_s"]) + 3.0,
                        cfg["model"]["vocab_size"])
    session = driver.Session(cfg, mix, seed, "cpu")
    session.warm(reqs)
    rec = session.run(reqs, 3.0, time.perf_counter())
    session.close()
    assert rec["counters"]["steps"] > 0
    for name in NAMES:
        v = harness.load_reader(name).read(rec)
        assert v is not None and math.isfinite(v) and v >= 0, name
    assert 0 <= harness.load_reader(
        "executor.prefill_pad_share").read(rec) < 100
