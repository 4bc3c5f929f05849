"""The end-to-end arithmetic: due-time TTFT with unfinished requests,
gaps between deliveries, rate as all work over all time, the idle share
as a union of intervals, and the per-layer readers on a hand-made
record."""
import pytest

from servebench import harness, itl_split, trace, window


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


def _two_population_rec(long_share, n=1000):
    """One request's n gaps: decode-only steps of 18-24 ms, and a
    long_share of steps that carry a prefill, 90-110 ms, spread evenly."""
    n_long = round(long_share * n)
    longs = {j * n // n_long for j in range(n_long)}
    t, times, steps = 0.0, [0.0], []
    for i in range(n):
        t += (0.090 + (i % 21) * 1e-3) if i in longs else \
            (0.018 + (i % 7) * 1e-3)
        times.append(t)
        steps.append({"t0": times[-2], "t": t, "decode": [("base", 512)],
                      "prefill": [("base", 512)] if i in longs else []})
    return {"w0": -1.0, "w_end": t, "w1": t,
            "requests": [{"due": -1.0, "times": times}], "steps": steps}


@pytest.mark.parametrize("long_share", [0.04, 0.06])
def test_itl_p50_reads_decode_and_p99_reads_prefill_gaps(long_share):
    rec = _two_population_rec(long_share)
    assert 17.9 < harness.load_reader("itl_p50_ms").read(rec) < 24.1
    assert 89.9 < 1e3 * window.percentile(window.itl_s(rec), 99) < 110.1
    assert harness.load_reader("itl_p50_ms").read(
        {"w0": 0.0, "w1": 1.0, "requests": [{"times": [0.5]}]}) is None


def test_a_p95_lands_in_either_population_by_the_prefill_share():
    """The fault the p50 replaces: at 4% of prefill gaps the 95th
    percentile reads a decode gap, at 6% a prefill gap."""
    p95 = [1e3 * window.percentile(window.itl_s(_two_population_rec(s)), 95)
           for s in (0.04, 0.06)]
    assert p95[0] < 24.1 and p95[1] > 89.9


def test_itl_pairs_walk_the_gaps_that_itl_s_takes():
    rec = _rec()
    assert [b - a for a, b in window.itl_pairs(rec)] == window.itl_s(rec)
    assert all(rec["w0"] < b <= rec["w1"] for _, b in window.itl_pairs(rec))


def test_itl_split_places_each_percentile_in_its_population():
    out = itl_split.itl_split(_two_population_rec(0.04))
    assert (out["gaps"], out["prefill_gaps"], out["prefill_steps"]) == \
        (1000, 40, 40)
    assert out["prefill_share"] == pytest.approx(0.04)
    assert out["decode_ms"] == pytest.approx([18.0, 24.0])
    assert out["prefill_ms"] == pytest.approx([90.0, 110.0])
    assert 90.0 < out["prefill_p50_ms"] < 110.0
    assert out["p50"]["prefill_share_at_or_below"] == 0
    assert 0 < out["p50"]["decode_share_at_or_below"] < 1
    for q in ("p98", "p99"):
        assert out[q]["decode_share_at_or_below"] == 1
        assert 0 < out[q]["prefill_share_at_or_below"] < 1
    # p99 is 105 ms; 9 of the 40 long gaps lie above it
    assert out["p99"]["ms"] == pytest.approx(105.0)
    assert out["p99"]["prefill_steps_beyond"] == 9
    assert out["p98"]["prefill_steps_beyond"] > out["p99"]["prefill_steps_beyond"]
    assert out["p95"]["prefill_share_at_or_below"] == 0


def test_itl_split_raises_without_a_record(monkeypatch, tmp_path):
    from servebench import run
    monkeypatch.setattr(run, "main", lambda argv=None: 0)
    with pytest.raises(RuntimeError, match="no record"):
        itl_split.main(["--out", str(tmp_path / "split.jsonl"),
                        "--workload", "zoo12b-chat", "--seed", "1",
                        "--seconds", "1", "--trace", "0"])
    assert not (tmp_path / "split.jsonl").exists()


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
