"""The paper's §5.1 transfer-vs-recalc decision for single-host preemption,
instantiated with NVIDIA H100 SXM constants — the port of
``repro.serving.cost_model.preempt_readmit_strategy``.

The reference reads TPU v5e constants (``repro/serving/cluster.py``); this
file carries the H100's instead, from NVIDIA's H100 Tensor Core GPU data
sheet (SXM5 column): 989 TFLOP/s dense BF16 tensor-core throughput,
3.35 TB/s HBM3 bandwidth, and a PCIe Gen5 x16 host link (128 GB/s both
directions together, so 64 GB/s each way).  The simulator's ``Cluster`` is
not part of the port yet.
"""
from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = 989e12        # dense bf16, FLOP/s
HBM_BW = 3.35e12           # B/s
HOST_TO_DEVICE_BW = 64e9   # B/s, PCIe Gen5 x16, one direction


def preempt_readmit_strategy(kv_bytes: int, prefix_flops: float,
                             mfu_cap: float = 0.6) -> Tuple[str, float]:
    """§5.1 transfer-vs-recalc applied to single-host preemption: spilling
    a preempted request's pages costs a host-link round trip (out at
    eviction, back at readmission); recalculation replays the prefix
    matmuls at readmission.  Returns (strategy, estimated seconds)."""
    t_spill = 2.0 * kv_bytes / HOST_TO_DEVICE_BW
    t_rec = prefix_flops / (PEAK_FLOPS * mfu_cap)
    return ("spill", t_spill) if t_spill <= t_rec else ("recalc", t_rec)
