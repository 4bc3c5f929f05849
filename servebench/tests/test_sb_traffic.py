"""The generator repeats by seed, gives its stated distributions, the
stated (unscaled) rate and the same multiset of sizes to every seed."""
import numpy as np
import pytest

from servebench.traffic import gen

MIX = {"loop": "open", "arrival": "poisson", "rate_rps": 2.0,
       "apps": {"a": 0.5, "b": 0.3, "c": 0.2},
       "prompt_len": {"dist": "lognormal", "median": 768, "sigma": 0.7,
                      "min": 64, "max": 3072},
       "output_len": {"dist": "lognormal", "median": 160, "sigma": 0.6,
                      "min": 16, "max": 512}}


def _key(reqs):
    return [(r.app, r.prompt_len, r.gen_len, r.due, r.prompt.tobytes())
            for r in reqs]


def test_same_seed_same_requests():
    a = gen.generate(MIX, 2 ** 33 + 5, 60.0, 1000)
    b = gen.generate(MIX, 2 ** 33 + 5, 60.0, 1000)
    assert _key(a) == _key(b)
    c = gen.generate(MIX, 2 ** 33 + 6, 60.0, 1000)
    assert _key(a) != _key(c)


def test_every_seed_gets_the_same_sizes_and_gaps():
    a = gen.generate(MIX, 1, 60.0, 1000)
    b = gen.generate(MIX, 99, 60.0, 1000)
    for f in ("prompt_len", "gen_len", "app"):
        assert sorted(getattr(r, f) for r in a) == sorted(
            getattr(r, f) for r in b)
    ga = np.diff([0.0] + [r.due for r in a])
    gb = np.diff([0.0] + [r.due for r in b])
    np.testing.assert_allclose(np.sort(ga), np.sort(gb), rtol=1e-9)


@pytest.mark.parametrize("n", [10, 121, 1000])
def test_rate_is_the_stated_one(n):
    gaps = gen.exponential_gaps(2.5, n)
    assert gaps.sum() == pytest.approx(n / 2.5, rel=1e-9)
    assert np.all(np.diff(gaps) > 0)


def test_request_count_covers_the_horizon():
    reqs = gen.generate(MIX, 3, 60.0, 1000)
    assert len(reqs) == gen.request_count(MIX, 60.0) == 121
    # the gaps sum to n / rate, so the last due lies near the horizon
    assert reqs[-1].due == pytest.approx(len(reqs) / MIX["rate_rps"],
                                         rel=1e-9)
    assert all(a.due <= b.due for a, b in zip(reqs, reqs[1:]))


def test_length_distribution():
    spec = MIX["prompt_len"]
    x = gen.length_quantiles(spec, 1001)
    assert x.min() >= 64 and x.max() <= 3072
    assert np.median(x) == 768
    # the stated sigma: the 84th percentile of a lognormal is median * e^s
    assert np.percentile(x, 84.1345) == pytest.approx(
        768 * np.exp(0.7), rel=0.01)


def test_app_shares_are_exact():
    apps = gen.app_counts({"a": 0.5, "b": 0.3, "c": 0.2}, 10)
    assert apps.count("a") == 5 and apps.count("b") == 3 \
        and apps.count("c") == 2
    assert len(gen.app_counts({"a": 1, "b": 1, "c": 1}, 7)) == 7


def test_preroll_inflight():
    mix = dict(MIX, preroll_inflight=8)
    reqs = gen.generate(mix, 4, 10.0, 1000)
    head = reqs[:8]
    assert all(r.due == 0.0 and r.gen_len >= 2 for r in head)
    assert [r.idx for r in reqs] == list(range(len(reqs)))
    full = sorted(gen.length_quantiles(MIX["output_len"], 8))
    assert sum(r.gen_len for r in head) < sum(full)


def test_prompt_tokens_in_vocab():
    for r in gen.generate(MIX, 5, 20.0, 37):
        assert r.prompt.dtype == np.int32 and len(r.prompt) == r.prompt_len
        assert r.prompt.min() >= 0 and r.prompt.max() < 37


def test_closed_loop_has_no_due_times():
    mix = dict(MIX, loop="closed", clients=4, requests=12)
    reqs = gen.generate(mix, 6, 0.0, 100)
    assert len(reqs) == 12 and all(r.due is None for r in reqs)
