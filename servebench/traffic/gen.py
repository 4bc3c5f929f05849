"""The one traffic generator: reads a mix file (``traffic/<mix>.json``) and
draws the requests of one run from ``--seed``.

Every seed gets the same multiset of sizes and inter-arrival gaps, in
another order, so that two seeds differ in the order of the work and in
the token ids, not in its amount:

- lengths are the stratified quantiles ``(i + 0.5) / n`` of the stated
  distribution, clipped to ``[min, max]``;
- Poisson gaps are the exact means of the ``n`` equal-probability strata
  of the exponential distribution, so they sum to ``n / rate``: the rate
  is the stated one, never rescaled to fit a duration;
- app shares are exact counts (largest remainder).

The seed permutes each of these lists on its own and draws the prompt
token ids.  A mix is open loop (``"loop": "open"``: each request has a due
time, sent whether or not earlier ones finished) or closed loop
(``"loop": "closed"``: ``clients`` callers, each sending its next request
when the last one finished; the serving path sets the due times).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent


@dataclass
class Request:
    idx: int
    app: str
    prompt_len: int
    gen_len: int
    due: Optional[float]          # seconds after the start of the pre-roll
    prompt: np.ndarray = field(repr=False)  # (prompt_len,) int32


def load_mix(name: str) -> dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def length_quantiles(spec: dict, n: int) -> np.ndarray:
    """n stratified draws of a clipped length distribution, ascending."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"length distribution {spec['dist']!r}")
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.round(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """The means of n equal-probability strata of Exp(rate), ascending;
    they sum to n / rate exactly (up to rounding)."""
    def F(u):  # an antiderivative of the exponential quantile -ln(1 - u)
        r = 1.0 - u
        return r * math.log(r) - r if r > 0 else 0.0
    return np.array([n * (F((i + 1) / n) - F(i / n))
                     for i in range(n)]) / rate


def app_counts(shares: Dict[str, float], n: int) -> List[str]:
    """Exact counts by largest remainder, in the mix's order."""
    total = sum(shares.values())
    raw = {a: n * s / total for a, s in shares.items()}
    counts = {a: int(math.floor(v)) for a, v in raw.items()}
    rest = n - sum(counts.values())
    for a in sorted(raw, key=lambda a: counts[a] - raw[a])[:rest]:
        counts[a] += 1
    return [a for a in shares for _ in range(counts[a])]


def request_count(mix: dict, horizon_s: float) -> int:
    """Requests drawn for a run whose traffic spans ``horizon_s`` seconds
    (pre-roll and window): enough that the last is due after it ends."""
    if mix["loop"] == "open":
        return int(math.ceil(mix["rate_rps"] * horizon_s)) + 1
    return int(mix["requests"])


def generate(mix: dict, seed: int, horizon_s: float, vocab: int
             ) -> List[Request]:
    """The run's requests in due order (open loop) or send order (closed).

    An open-loop mix may start its pre-roll with ``preroll_inflight``
    requests due at once, as if caught mid-flight: the mix's own sizes,
    each output cut to a stratified share of its length (at least 2), so
    the in-flight count starts near its steady value instead of climbing
    to it for a whole request lifetime."""
    n = request_count(mix, horizon_s)
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    n0 = int(mix.get("preroll_inflight", 0))
    if n0:
        prompts = rng.permutation(length_quantiles(mix["prompt_len"], n0))
        left = rng.permutation((np.arange(n0) + 0.5) / n0)
        outputs = np.maximum(2, np.round(rng.permutation(
            length_quantiles(mix["output_len"], n0)) * left)).astype(int)
        apps = [str(a) for a in rng.permutation(app_counts(mix["apps"], n0))]
        for i in range(n0):
            p = int(prompts[i])
            out.append(Request(
                idx=i, app=apps[i], prompt_len=p, gen_len=int(outputs[i]),
                due=0.0, prompt=rng.integers(0, vocab, size=p,
                                             dtype=np.int32)))
    prompts = rng.permutation(length_quantiles(mix["prompt_len"], n))
    outputs = rng.permutation(length_quantiles(mix["output_len"], n))
    apps = [str(a) for a in rng.permutation(app_counts(mix["apps"], n))]
    if mix["loop"] == "open":
        if mix.get("arrival", "poisson") != "poisson":
            raise ValueError(f"arrival process {mix['arrival']!r}")
        dues = np.cumsum(rng.permutation(exponential_gaps(mix["rate_rps"],
                                                          n)))
    elif mix["loop"] == "closed":
        dues = [None] * n
    else:
        raise ValueError(f"loop {mix['loop']!r}")
    for i in range(n):
        p = int(prompts[i])
        out.append(Request(
            idx=n0 + i, app=apps[i], prompt_len=p, gen_len=int(outputs[i]),
            due=None if dues[i] is None else float(dues[i]),
            prompt=rng.integers(0, vocab, size=p, dtype=np.int32)))
    return out
