"""The control: the reference in the program's place one precision below
the served bfloat16 (float8 e4m3) must come out not correct.

On the card the cell runs at its own size on three seeds (``cuda``; about
three minutes a seed); on the CPU the same reading at a small size must
at least read wider than the program's."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from servebench import harness
from servebench.tests import _tiny

ROOT = Path(__file__).resolve().parents[2]


def test_control_reads_wider_than_the_program_on_cpu():
    out = _tiny.run(cfg=_tiny.config(_tiny.DEMO), mix=_tiny.mix(),
                    control=True)
    c = out["checks"]
    assert c["control_widest_gap"]["value"] > c["widest_gap"]["value"]
    assert out["sample"]["control_flips"] > out["sample"]["flips"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3141592653, 2718281829, 1618033988])
def test_control_fails_at_the_cells_size(card, seed):
    limit = harness.load_config("stablelm2-12b-zoo")["check"]["widest_gap"]
    res = subprocess.run(
        [sys.executable, "servebench/run.py", "--workload", "zoo12b-chat",
         "--seed", str(seed), "--seconds", "20", "--trace", "0",
         "--control", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    print(seed, json.dumps(out["checks"]), json.dumps(out["sample"]))
    assert out["correct"], out["checks"]
    assert out["checks"]["control_widest_gap"]["value"] > limit
