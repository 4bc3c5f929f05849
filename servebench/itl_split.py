#!/usr/bin/env python3
"""Run one cell as ``run.py`` does, and write where its ITL percentiles
fell between the two populations of gaps.

    python3 servebench/itl_split.py --workload <cell> --seed <n> \
        --seconds <s> --trace 0 --out <file.jsonl>

Standard output and standard error are ``run.py``'s, the result line
included.  Once the run has ended, one JSON line is appended to ``--out``:
the gaps that end on a decode-only step and those that end on a step
carrying a prefill, their ranges, the median of the second, and where
the 50th, 95th, 98th and 99th percentiles of all gaps lie within each.
It raises if the run made no record.  A diagnostic of the metrics'
choice; the benchmark's runs do not call it.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _share_at_or_below(sorted_vals, v):
    return bisect.bisect_right(sorted_vals, v) / len(sorted_vals) \
        if sorted_vals else None


def itl_split(rec: dict) -> dict:
    """The window's ITL gaps (``window.itl_pairs``) split by the
    step each ends on: one that carried a prefill, or a decode-only one.
    For each percentile q of all gaps: its value in ms and the share of
    each population at or below it."""
    from servebench.window import itl_pairs, percentile
    pre_ends = {s["t"] for s in rec["steps"] if s["prefill"]}
    dec, pre, step_max = [], [], {}
    for a, b in itl_pairs(rec):
        if b in pre_ends:
            pre.append(b - a)
            step_max[b] = max(step_max.get(b, 0.0), b - a)
        else:
            dec.append(b - a)
    dec.sort()
    pre.sort()
    gaps = dec + pre
    out = {"gaps": len(gaps), "prefill_gaps": len(pre),
           "prefill_share": len(pre) / len(gaps) if gaps else None,
           "prefill_steps": len(step_max),
           "decode_ms": [dec[0] * 1e3, dec[-1] * 1e3] if dec else None,
           "prefill_ms": [pre[0] * 1e3, pre[-1] * 1e3] if pre else None,
           "prefill_p50_ms": percentile(pre, 50) * 1e3 if pre else None}
    for q in (50, 95, 98, 99):
        v = percentile(gaps, q)
        if v is None:
            continue
        out[f"p{q}"] = {
            "ms": v * 1e3,
            "decode_share_at_or_below": _share_at_or_below(dec, v),
            "prefill_share_at_or_below": _share_at_or_below(pre, v),
            "prefill_steps_beyond": sum(1 for g in step_max.values()
                                        if g > v)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    args, rest = ap.parse_known_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from servebench import harness, run
    run.T_PROC = T_PROC
    cell = run.parse(rest)
    cfg = harness.load_config(
        harness.cell_of(harness.load_bench(), cell.workload)["config"])
    driver = importlib.import_module(f"servebench.drivers.{cfg['driver']}")
    kept = []
    plain = driver.Session.run

    def keep(self, *a, **k):
        rec = plain(self, *a, **k)
        kept.append(rec)
        return rec

    driver.Session.run = keep
    rc = run.main(rest)
    if rc != 0:
        return rc
    if not kept:
        raise RuntimeError(f"servebench.drivers.{cfg['driver']}.Session.run "
                           "was not called: no record to split")
    line = {"workload": cell.workload, "seed": cell.seed,
            "trace": cell.trace, **itl_split(kept[0])}
    with open(args.out, "a") as f:
        f.write(json.dumps(line) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
