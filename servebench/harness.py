"""One run of one cell: the cell's configuration, traffic mix, driver and
metric readers are found by the names ``BENCHMARK.json`` gives them.

- ``configs/<config>.json``: the configuration as it is run; its
  ``driver`` names ``drivers/<driver>.py`` and its ``reference`` names
  ``reference/<reference>.py``.
- ``traffic/<mix>.json``: the mix, read by ``traffic/gen.py``.
- ``metrics/<metric>.py``: one reader per metric, ``read(record)``, which
  returns None where it finds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import List, Optional

import torch

from servebench import check
from servebench.trace import DeviceTracer
from servebench.traffic import gen
from servebench.window import due_in_window

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_bench(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell_of(bench: dict, workload: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == workload:
            return c
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} ({path})")
    return json.loads(path.read_text())


def metrics_for(bench: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "servebench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def device_info(device: str, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_proc: float, device: str = "cuda", bench: Optional[dict] = None,
             cfg: Optional[dict] = None, mix: Optional[dict] = None,
             control: bool = False) -> dict:
    """The result line's object.  ``cfg``/``mix`` stand in for the cell's
    files (the CPU tests' small sizes)."""
    bench = bench or load_bench()
    cell = cell_of(bench, workload)
    cfg = cfg or load_config(cell["config"])
    mix = mix or gen.load_mix(cell["traffic"])
    driver = importlib.import_module(f"servebench.drivers.{cfg['driver']}")
    reqs = gen.generate(mix, seed, float(mix["preroll_s"]) + seconds,
                        cfg["model"]["vocab_size"])
    session = driver.Session(cfg, mix, seed, device)
    session.warm(reqs)
    tracer = None
    if trace:
        tracer = DeviceTracer(session.host_spans())
        tracer.prime()
    rec = session.run(reqs, seconds, t_proc, tracer)
    if tracer is not None:
        rec["trace"] = tracer.summary()
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, workload, kind):
        v = load_reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = device_info(device, cell["chips"])
    if dev["platform"] == "gpu":
        dev["memory_peak_bytes"] = max(rec["setup_peak_bytes"],
                                       rec["window_peak_bytes"])
    if trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
    # the comparison: after the window, with the program's state freed
    chk = cfg["check"]
    sample = check.pick_sample(rec["requests"], session.finished, seed,
                               chk["min_tokens"], chk["max_requests"])
    weights, dims, finished = session.weights, session.dims, session.finished
    session.close()
    checks = {}
    correct = False
    if sample:
        numbers = check.compare(cfg, weights, dims, reqs, finished, sample,
                                torch.device(device), control=control)
        checks["widest_gap"] = {"value": numbers["widest_gap"],
                                "limit": chk["widest_gap"]}
        correct = numbers["widest_gap"] <= chk["widest_gap"]
        if control:
            checks["control_widest_gap"] = {
                "value": numbers["control_widest_gap"],
                "limit": chk["widest_gap"]}
        info = {k: v for k, v in numbers.items()
                if k not in ("widest_gap", "control_widest_gap")}
    else:
        info = {"requests": 0}
    out = {"correct": bool(correct), "attempted": due_in_window(rec),
           "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["sample"] = info
    out["setup_parts"] = rec.get("setup_parts", {})
    out["checks"] = checks
    return out
