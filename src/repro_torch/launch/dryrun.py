"""Multi-pod dry-run: trace every (arch x shape) on the production meshes
and record its per-device cost for the roofline — the port of
``repro.launch.dryrun``.

A cell's step (``launch.steps.build_cell``) runs once on DTensors whose
shards live on the ``meta`` device, over a ``DeviceMesh`` of 256 (or 512)
ranks under torch's ``fake`` process group (``launch.mesh``): nothing is
allocated and no collective moves data, so the cell's shapes and
collectives are the production mesh's while its values are never
computed.  This is the reference's forced-CPU-host semantics, not a
fallback: the dry-run never claims to have run on a card.  Attention takes
the reference's plain route there (no kernel runs on ``meta``).
``hlo_analysis.DeviceCost`` counts what each device runs.

MUST be run as its own process (the fake group fixes the world size for
the process).  ``--all`` runs one cell per subprocess.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] [--force] [--jobs 6]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
CELL_TIMEOUT_S = 3600

ARCHS = [
    "qwen2-vl-7b", "mixtral-8x22b", "dbrx-132b", "stablelm-12b",
    "tinyllama-1.1b", "qwen1.5-32b", "qwen2-72b", "zamba2-2.7b",
    "xlstm-125m", "seamless-m4t-medium",
]


def input_specs(arch: str, shape_name: str):
    """``meta`` stand-ins for every model input (no allocation)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.model import build_model

    cfg = get_config(arch)
    return build_model(cfg).batch_specs(SHAPES[shape_name])


def model_flops(cfg, shape) -> float:
    """The analytic model FLOPs (the roofline's numerator): 6·N·T to
    train, 2·N·T to prefill, 2·N·B a decode step; N the active params."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: dict | None = None, cfg=None) -> dict:
    """Trace one cell and return its record.  ``cfg`` replaces the
    registered config (a reduced one, in tests)."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.hlo_analysis import DeviceCost, local_bytes
    from repro_torch.launch.mesh import (
        init_fake_process_group,
        make_production_mesh,
        production_world_size,
    )
    from repro_torch.launch.steps import build_cell, place

    cfg = cfg if cfg is not None else get_config(arch)
    if overrides:
        cfg = cfg.replace(**{k: v for k, v in overrides.items()
                             if k in cfg.__dataclass_fields__})
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
                "skipped": "pure full-attention arch (DESIGN.md §4)"}
    multi = mesh_kind == "multi"
    if not dist.is_initialized():
        init_fake_process_group(production_world_size(multi_pod=multi))
    mesh = make_production_mesh(multi_pod=multi)
    vocab_chunk = (overrides or {}).get("vocab_chunk", 0)
    fn, arg_structs, in_pl, _, _ = build_cell(cfg, shape, mesh,
                                              vocab_chunk=vocab_chunk)
    args = [place(s, pl, mesh) for s, pl in zip(arg_structs, in_pl)]
    arg_bytes = local_bytes(args)

    t0 = time.time()
    with DeviceCost() as cost:
        out = fn(*args)
    t_trace = time.time() - t0
    totals = cost.totals()
    print({k: totals[k] for k in ("flops", "bytes", "collective_bytes")})

    n_chips = 1
    for s in mesh.shape:
        n_chips *= s
    return {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh_kind,
        "chips": n_chips,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": local_bytes(out),
            "note": "this device's shards",
        },
        "hlo_per_device": totals,  # per device, counted on local shards
        "overrides": overrides or {},
        "model_flops": model_flops(cfg, shape),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }


def cell_list(mesh_arg: str):
    from repro_torch.configs import SHAPES, get_config

    meshes = ["single", "multi"] if mesh_arg == "both" else [mesh_arg]
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.supports_long_context:
                cells.append((arch, shape.name, None))  # record skip once
                continue
            for m in meshes:
                cells.append((arch, shape.name, m))
    return cells


def _run_subprocess(cell, args) -> bool:
    """One cell of ``--all`` in its own process; prints its outcome and
    wall; True if it wrote its record."""
    arch, shape, m = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", m,
           "--tag", args.tag] + sum([["--set", s] for s in args.set], [])
    print(f"[cell] {arch} {shape} {m} ...", flush=True)
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=CELL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"[FAIL] {arch} {shape} {m}: timed out after "
              f"{CELL_TIMEOUT_S} s", flush=True)
        return False
    if r.returncode != 0:
        print(f"[FAIL] {arch} {shape} {m} ({time.time() - t0:.1f} s)"
              f"\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}", flush=True)
        return False
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else "ok"
    print(f"[ok] {arch} {shape} {m} ({time.time() - t0:.1f} s): {last}",
          flush=True)
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf experiments)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells traced at once, one process each")
    args = ap.parse_args()

    OUT_DIR.mkdir(parents=True, exist_ok=True)

    if args.all:
        todo = []
        for arch, shape, m in cell_list(args.mesh):
            mesh_name = m or "skip"
            out = OUT_DIR / f"{args.tag}__{arch}__{shape}__{mesh_name}.json"
            if out.exists() and not args.force:
                continue
            if m is None:
                out.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": "skip",
                    "skipped": "pure full-attention arch (DESIGN.md §4)"},
                    indent=1))
                print(f"[skip] {arch} {shape}")
                continue
            todo.append((arch, shape, m))
        with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
            done = list(pool.map(lambda c: _run_subprocess(c, args), todo))
        failures = [cell for cell, ok in zip(todo, done) if not ok]
        print(f"done; {len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    rec = run_cell(args.arch, args.shape, args.mesh, overrides or None)
    out = OUT_DIR / f"{args.tag}__{args.arch}__{args.shape}__{args.mesh}.json"
    out.write_text(json.dumps(rec, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
