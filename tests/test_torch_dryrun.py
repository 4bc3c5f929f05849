"""The port's dry-run (``repro_torch.launch.dryrun``), its per-device cost
counter (``launch.hlo_analysis``) and the roofline (``launch.roofline``).

One reduced TinyLlama train cell is traced on the production (16, 16) mesh
under torch's ``fake`` process group (set up by the fixture and torn down
after it), its shards on the ``meta`` device.  Its record must carry the
listed fields; its ``model_flops`` must be the reference's formula; its
per-device FLOPs must be below the step's global FLOPs (counted with
``FlopCounterMode`` on the same step on plain ``meta`` tensors), so they
were counted on shards, and at least ``model_flops`` over the 256 devices
(replicated work and recompute only add to it); its collectives must move
bytes.  The cell list is the reference's.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, ShapeConfig, get_reduced_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import HBM_BW, INTRA_SERVER_BW, PEAK_FLOPS
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import TrainConfig, make_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
SHAPE = ShapeConfig("reduced_train", 64, 32, "train")


@pytest.fixture(scope="module")
def record():
    torch.set_num_threads(2)
    try:
        yield dryrun.run_cell(ARCH, SHAPE, "single",
                              cfg=get_reduced_config(ARCH))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _global_train_flops(cfg, shape) -> float:
    """FLOPs of the whole train step on plain ``meta`` tensors."""
    model = build_model(cfg)
    params = model.param_shapes()
    batch = model.batch_specs(shape)
    with FlopCounterMode(display=False) as fc:
        make_train_step(model, TrainConfig())(params, adamw_init(params),
                                              batch)
    return float(fc.get_total_flops())


def test_record_fields(record):
    for key in ("arch", "shape", "kind", "mesh", "chips", "seq_len",
                "global_batch", "trace_s", "memory", "hlo_per_device",
                "overrides", "model_flops", "params_total", "params_active"):
        assert key in record, key
    assert record["chips"] == 256 and record["kind"] == "train"
    h = record["hlo_per_device"]
    for key in ("flops", "bytes", "bytes_read", "bytes_written",
                "collectives", "collective_bytes", "collective_counts"):
        assert key in h, key
    assert record["memory"]["argument_bytes"] > 0
    assert record["memory"]["output_bytes"] > 0
    assert h["bytes"] == h["bytes_read"] + h["bytes_written"] > 0
    json.dumps(record)  # a record is written as JSON


def test_model_flops_is_the_reference_formula(record):
    cfg = get_reduced_config(ARCH)
    n = cfg.active_param_count()
    assert record["model_flops"] == 6.0 * n * SHAPE.global_batch * \
        SHAPE.seq_len
    assert record["params_total"] == record["params_active"] == \
        cfg.param_count()
    prefill = ShapeConfig("p", 64, 32, "prefill")
    decode = ShapeConfig("d", 64, 32, "decode")
    assert dryrun.model_flops(cfg, prefill) == 2.0 * n * 32 * 64
    assert dryrun.model_flops(cfg, decode) == 2.0 * n * 32


def test_flops_counted_per_device(record):
    """Per-device FLOPs are below the step's global FLOPs (so they were
    counted on local shards), and 256 devices do at least the model's
    FLOPs."""
    per_dev = record["hlo_per_device"]["flops"]
    total = _global_train_flops(get_reduced_config(ARCH), SHAPE)
    assert 0 < per_dev < total
    assert per_dev * record["chips"] >= record["model_flops"]


def test_train_cell_moves_collective_bytes(record):
    h = record["hlo_per_device"]
    assert h["collective_bytes"] > 0
    assert h["collective_bytes"] == sum(h["collectives"].values())
    assert set(h["collectives"]) <= {"all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all",
                                     "collective-permute"}
    assert sum(h["collective_counts"].values()) > 0


def test_long_context_skip():
    rec = dryrun.run_cell(ARCH, "long_500k", "single")
    assert "skipped" in rec and rec["shape"] == "long_500k"


_REF_CELLS = r'''
import pickle
from repro.launch.dryrun import ARCHS, cell_list
with open({out!r}, "wb") as f:
    pickle.dump({{"archs": ARCHS, "single": cell_list("single"),
                 "both": cell_list("both")}}, f)
'''


def test_cell_list_matches_reference():
    from test_torch_model_api import jax_fp32_pickle

    want = jax_fp32_pickle(_REF_CELLS)
    assert dryrun.ARCHS == want["archs"]
    assert dryrun.cell_list("single") == want["single"]
    assert dryrun.cell_list("both") == want["both"]
    assert len([c for c in want["both"] if c[2]]) + \
        len([c for c in want["both"] if not c[2]]) == len(want["both"])


def _synthetic(**h):
    base = {"flops": 989e12, "bytes": 3.35e12 / 2, "collective_bytes": 45e9}
    base.update(h)
    return {"arch": "a", "shape": "decode_32k", "chips": 256,
            "model_flops": 256 * 989e12 / 4, "hlo_per_device": base,
            "memory": {"argument_bytes": 2e9}}


def test_roofline_terms():
    t = roofline.terms(_synthetic())
    assert t["compute_s"] == pytest.approx(989e12 / PEAK_FLOPS) == 1.0
    assert t["memory_s"] == pytest.approx(3.35e12 / 2 / HBM_BW) == 0.5
    assert t["collective_s"] == pytest.approx(45e9 / INTRA_SERVER_BW) == 0.1
    assert t["dominant"] == "compute"
    assert t["useful_flops_ratio"] == pytest.approx(0.25)
    assert t["roofline_frac"] == pytest.approx(1.0)
    assert t["arg_gb"] == pytest.approx(2.0)
    t = roofline.terms(_synthetic(collective_bytes=900e9))
    assert t["dominant"] == "collective"
    assert t["roofline_frac"] == pytest.approx(0.5)


def test_roofline_table(tmp_path):
    recs = {"x": _synthetic(), "y": _synthetic(bytes=3.35e13)}
    for name, rec in recs.items():
        rec["arch"] = name
        (tmp_path / f"t__{name}__decode_32k__single.json").write_text(
            json.dumps(rec))
    (tmp_path / "t__z__long_500k__single.json").write_text(json.dumps(
        {"arch": "z", "shape": "long_500k", "skipped": "why"}))
    tbl, rows = roofline.table("t", "single", tmp_path)
    assert len(rows) == 2 and "skipped" in tbl
    assert [r["dominant"] for r in rows] == ["compute", "memory"]
    picks = roofline.pick_hillclimb_cells(rows)
    assert picks["paper_representative"]["arch"] == "y"
    assert picks["worst_fraction"]["arch"] == "y"


def test_dryrun_cli_writes_a_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` in its own process writes a
    record for a cell (the reduced shape via ``--set``, the full config's
    other fields), here the long-context skip, which needs no trace."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    code = ("import sys; from pathlib import Path; "
            "from repro_torch.launch import dryrun; "
            f"dryrun.OUT_DIR = Path({str(tmp_path)!r}); "
            "sys.argv = ['dryrun', '--arch', 'qwen2-72b', '--shape', "
            "'long_500k', '--tag', 't']; dryrun.main()")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads((tmp_path / "t__qwen2-72b__long_500k__single.json")
                     .read_text())
    assert rec["skipped"] and rec["shape"] == "long_500k"
    assert SHAPES["long_500k"].seq_len == 524_288
