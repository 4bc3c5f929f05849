#!/usr/bin/env python3
"""Find the knee of an open-loop cell: the highest offered rate the system
sustains without a growing backlog.

    python3 servebench/knee.py --workload <cell> --seed <n> --seconds <s> \
        --rates 0.6 0.9 1.2 1.5

One process, one set-up: for each rate (ascending) a fresh engine over the
same zoo serves the cell's mix at that rate (pre-roll, then the window)
and one JSON line reports what was offered and completed and how the
in-flight count moved across the window.  A rate sustains when the output
tokens delivered in the window reach ``--keep`` of the tokens offered
(the rate times the mix's mean output length) and nothing waits
unadmitted at the end: beyond the knee the in-flight count grows and the
delivered rate stays flat.
Record the knee and the rate the cell runs at (about four fifths of it)
in the mix file by hand; the benchmark's runs never search.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def quarter_means(rec):
    """Mean in-flight count over the first and the last quarter of the
    window's steps."""
    steps = [s for s in rec["steps"] if s["t"] > rec["w0"]]
    q = max(1, len(steps) // 4)
    first = sum(s["inflight"] for s in steps[:q]) / q
    last = sum(s["inflight"] for s in steps[-q:]) / q
    return first, last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--keep", type=float, default=0.95)
    ap.add_argument("--dump", default=None,
                    help="write each rate's steps (start, end, prefills, "
                         "decodes, in flight, group calls) as JSON lines "
                         "to this file")
    ap.add_argument("--inflight-per-rps", type=float, default=None,
                    help="start each pre-roll with rate x this many requests "
                         "in flight (default: the mix's preroll_inflight)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    torch.set_num_threads(1)  # one process, one host thread: steadier runs
    if not torch.cuda.is_available():
        print("knee: no CUDA device", file=sys.stderr)
        return 2
    from servebench import harness
    from servebench.traffic import gen
    from servebench.window import (itl_s, percentile, tokens_delivered,
                                   ttft_s)
    bench = harness.load_bench()
    cell = harness.cell_of(bench, args.workload)
    cfg = harness.load_config(cell["config"])
    mix0 = gen.load_mix(cell["traffic"])
    driver = __import__(f"servebench.drivers.{cfg['driver']}",
                        fromlist=["Session"])
    session = None
    for rate in sorted(args.rates):
        mix = dict(mix0, rate_rps=rate)
        if args.inflight_per_rps is not None:
            mix["preroll_inflight"] = int(round(rate * args.inflight_per_rps))
        reqs = gen.generate(mix, args.seed, mix["preroll_s"] + args.seconds,
                            cfg["model"]["vocab_size"])
        if session is None:
            session = driver.Session(cfg, mix, args.seed, "cuda")
            session.warm(reqs)
            print(json.dumps({"setup_s": time.perf_counter() - T_PROC,
                              **session.setup_parts}),
                  flush=True)
        else:
            session.mix = mix
            session.reset()
        rec = session.run(reqs, args.seconds, T_PROC)
        first, last = quarter_means(rec)
        if args.dump:
            with open(args.dump, "a") as f:
                f.write(json.dumps({"rate_rps": rate, "w0": rec["w0"],
                                    "steps": [[s["t0"], s["t"],
                                               len(s["prefill"]),
                                               len(s["decode"]),
                                               s["inflight"], s["groups"]]
                                              for s in rec["steps"]]}) + "\n")
        waiting = session.engine.scheduler.waiting
        due = sum(1 for r in rec["requests"] if r["due"] is not None
                  and rec["w0"] <= r["due"] < rec["w_end"])
        done = sum(1 for r in rec["requests"] if rec["w0"] < r.get(
            "done", 0) <= rec["w1"])
        ttft = percentile(ttft_s(rec), 90)
        gaps = itl_s(rec)
        itl50, itl99 = percentile(gaps, 50), percentile(gaps, 99)
        arrivals = [r for r in reqs if r.due and r.due > 0]
        offered = rate * sum(r.gen_len for r in arrivals) / len(arrivals)
        output = tokens_delivered(rec) / (rec["w1"] - rec["w0"])
        print(json.dumps({
            "rate_rps": rate, "due_in_window": due, "finished_in_window": done,
            "offered_tok_s": offered, "output_tok_s": output,
            "ttft_p90_ms": ttft and ttft * 1e3,
            "itl_p50_ms": itl50 and itl50 * 1e3,
            "itl_p99_ms": itl99 and itl99 * 1e3,
            "inflight_first_quarter": first, "inflight_last_quarter": last,
            "waiting_at_end": waiting,
            "step_p50_ms": (percentile(rec["step_wall_s"], 50) or 0) * 1e3,
            "preroll_inflight": mix.get("preroll_inflight", 0),
            "inflight_end": rec["steps"][-1]["inflight"],
            "sustained": output >= args.keep * offered and waiting == 0}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
