#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It drives ``repro_torch`` (under ``src/``)
on one NVIDIA GPU and exits non-zero, printing no result, when there is no
card, when the run fails, or when a module of JAX or of the JAX package
is loaded once the window has closed.  The last line of standard output
is one JSON object; the numbers compared for ``correct`` and their limits
are the last lines of standard error.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the float8 control (calibration only)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache = ROOT / ".servebench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        chips = next(c["chips"] for c in bench["workloads"]
                     if c["name"] == args.workload)
    except (OSError, StopIteration, KeyError, ValueError) as e:
        print(f"servebench: no workload {args.workload!r}: {e!r}",
              file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)  # one process, one host thread: steadier runs
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"servebench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        from servebench import harness
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_proc=T_PROC,
                                  bench=bench, control=bool(args.control))
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"servebench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
