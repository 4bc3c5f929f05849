"""Roofline aggregation over the dry-run records — the port of
``repro.launch.roofline``.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--tag baseline] [--mesh single]

Terms per (arch x shape), from each record's per-device counts
(``launch.hlo_analysis``), with the H100 SXM constants of
``serving.cluster`` (via ``launch.mesh``):
  compute    = flops_per_device / 989 TFLOP/s (dense bf16)
  memory     = bytes_per_device / 3.35 TB/s   (an unfused upper bound:
               every op's inputs and outputs once)
  collective = collective_bytes_per_device / 450 GB/s (NVLink 4, one
               direction, inside a server).  A 16-wide ``model`` axis spans
               two 8-GPU servers, and its collectives would cross
               ``INTER_SERVER_BW`` instead; this term assumes NVLink.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.mesh import HBM_BW, INTRA_SERVER_BW, PEAK_FLOPS

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def load_records(tag: str = "baseline", mesh: str = "single",
                 directory: Path = DRYRUN_DIR):
    recs = []
    for p in sorted(Path(directory).glob(f"{tag}__*__{mesh}.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def terms(rec: dict) -> dict:
    h = rec["hlo_per_device"]
    t_c = h["flops"] / PEAK_FLOPS
    t_m = h["bytes"] / HBM_BW
    t_l = h["collective_bytes"] / INTRA_SERVER_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_l, "collective"))[1]
    useful = rec["model_flops"] / max(h["flops"] * rec["chips"], 1.0)
    bound = max(t_c, t_m, t_l)
    roofline_frac = t_c / bound if bound > 0 else 0.0  # compute-term fraction
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_l,
        "dominant": dom,
        "useful_flops_ratio": useful,
        "roofline_frac": roofline_frac,
        "arg_gb": rec["memory"]["argument_bytes"] / 1e9,
    }


MOVE_HINTS = {
    "compute": "raise MFU: fuse attention, drop remat recompute, bigger "
               "matmul tiles",
    "memory": "cut HBM round-trips: fused (flash) attention, chunked CE, "
              "int8 KV, fewer score materializations",
    "collective": "reshard: reduce-scatter grads, overlap collectives with "
                  "compute, EP dispatch for MoE",
}


def table(tag: str = "baseline", mesh: str = "single",
          directory: Path = DRYRUN_DIR):
    recs = load_records(tag, mesh, directory)
    lines = [
        "| arch | shape | compute (s) | memory (s) | collective (s) | "
        "dominant | useful/traced | fix |",
        "|---|---|---|---|---|---|---|---|",
    ]
    rows = []
    for rec in recs:
        if "skipped" in rec:
            lines.append(f"| {rec['arch']} | {rec['shape']} | — | — | — | "
                         f"skipped | — | {rec['skipped']} |")
            continue
        t = terms(rec)
        rows.append(t)
        lines.append(
            f"| {t['arch']} | {t['shape']} | {t['compute_s']:.3e} | "
            f"{t['memory_s']:.3e} | {t['collective_s']:.3e} | "
            f"{t['dominant']} | {t['useful_flops_ratio']:.3f} | "
            f"{MOVE_HINTS[t['dominant']][:40]} |")
    return "\n".join(lines), rows


def pick_hillclimb_cells(rows):
    """Three most interesting cells: worst roofline fraction, most
    collective-bound, most representative of the paper (decode serving)."""
    worst = min(rows, key=lambda t: t["roofline_frac"])
    coll = max(rows, key=lambda t: t["collective_s"] /
               max(t["compute_s"] + t["memory_s"], 1e-12))
    serving = [t for t in rows if t["shape"] == "decode_32k"]
    rep = max(serving, key=lambda t: t["memory_s"]) if serving else rows[0]
    return {"worst_fraction": worst, "most_collective_bound": coll,
            "paper_representative": rep}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    tbl, rows = table(args.tag, args.mesh)
    print(tbl)
    print()
    if not rows:
        return
    picks = pick_hillclimb_cells(rows)
    for why, t in picks.items():
        print(f"hillclimb[{why}]: {t['arch']} x {t['shape']} "
              f"(dominant={t['dominant']}, useful={t['useful_flops_ratio']:.3f})")


if __name__ == "__main__":
    main()
