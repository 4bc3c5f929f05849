"""The end-to-end arithmetic: due-time TTFT with unfinished requests,
gaps between deliveries, rate as all work over all time, the idle share
as a union of intervals, and the per-layer readers on a hand-made
record."""
import pytest

from servebench import harness, trace, window


def _rec():
    # window (10, 20]; loop stopped at 20.5
    return {
        "t_proc": 0.0, "w0": 10.0, "w_end": 20.0, "w1": 20.5,
        "requests": [
            # due in the pre-roll: no TTFT sample, its tokens count
            {"due": 9.0, "times": [9.5, 10.5, 10.5, 11.0]},
            # due in the window, first token 1 s late
            {"due": 12.0, "times": [13.0, 13.0, 14.0, 16.0]},
            # due in the window, never served: waits until w1
            {"due": 18.0, "times": []},
            # due after the nominal end: not attempted
            {"due": 20.2, "times": [20.4]},
            # closed loop request never sent
            {"due": None, "times": []},
        ],
    }


def test_ttft_counts_from_due_and_unfinished_waits():
    assert sorted(window.ttft_s(_rec())) == pytest.approx([1.0, 2.5])


def test_itl_counts_deliveries_ending_in_window():
    # request 0: 9.5 -> 10.5 (ends in window), 10.5 -> 11.0;
    # request 1: 13 -> 14 -> 16
    assert sorted(window.itl_s(_rec())) == pytest.approx(
        [0.5, 1.0, 1.0, 2.0])


def test_tokens_delivered_and_due_count_the_window():
    rec = _rec()
    assert window.tokens_delivered(rec) == 3 + 4 + 1
    assert window.due_in_window(rec) == 2


def test_mfu_is_all_work_over_all_time():
    d = {"L": 2, "D": 8, "H": 4, "KVH": 2, "hd": 2, "F": 16, "V": 10}
    rec = {"dims": d, "lora_rank": {"l": 1}, "w0": 0.0, "w1": 2.0,
           "steps": [{"t0": -1.0, "t": 0.5, "prefill": [("b", 9)],
                      "decode": []},
                     {"t0": 0.5, "t": 1.0, "prefill": [("b", 3)],
                      "decode": [("l", 4)]}]}
    from servebench import counts
    want = (counts.prompt_flops(d, 3) + counts.token_flops(d, 4, 1)) / (
        2.0 * counts.PEAK_BF16_FLOPS) * 100
    assert harness.load_reader("step.mfu").read(rec) == pytest.approx(want)


def test_percentiles_and_readers():
    rec = _rec()
    assert harness.load_reader("ttft_p90_ms").read(rec) == pytest.approx(
        1000 * (1.0 + 0.9 * 1.5))
    assert harness.load_reader("setup_s").read(rec) == 10.0
    assert window.percentile([], 95) is None


def test_union_and_idle_gaps():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.merge(ivs) == [(0.0, 2.0), (3.0, 4.0)]
    assert trace.union_length(ivs) == pytest.approx(3.0)
    assert trace.idle_gaps(ivs, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                               (4.0, 5.0)]


def test_idle_share_reader():
    rec = {"trace": {"busy_s": 1.5, "window_s": 6.0}}
    assert harness.load_reader("device.idle_share").read(rec) == \
        pytest.approx(75.0)
    assert harness.load_reader("device.idle_share").read({}) is None


def test_label_at_takes_the_innermost_span():
    spans = [("engine.step", 0.0, 10.0), ("executor.fused_step", 2.0, 3.0)]
    assert trace.label_at(spans, 2.5) == "executor.fused_step"
    assert trace.label_at(spans, 5.0) == "engine.step"
    assert trace.label_at(spans, 11.0) == "harness"
