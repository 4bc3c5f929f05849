"""The paper's cost formulas (§5.1 I/O-vs-recalc, §5.3 latency estimation)
— the port of ``repro.serving.cost_model``, instantiated with the NVIDIA
H100 SXM constants of ``repro_torch.serving.cluster`` (the reference
reads TPU v5e ones); every time it gives is modeled, not measured.

All sizes in bytes, times in seconds.  ``BlockCost`` wraps one block's
static properties; zoo profiles can override the analytic compute model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.serving.cluster import (
    HBM_BW,
    HOST_TO_DEVICE_BW,
    PEAK_FLOPS,
    Cluster,
)


@dataclass(frozen=True)
class BlockCost:
    block_id: str
    param_bytes: int
    flops_per_token: float        # ~2 * params
    kv_bytes_per_token: int       # K+V bytes per token held by this block
    mfu_cap: float = 0.6          # achievable fraction of peak at large batch
    overhead_factor: float = 8.0  # software stack overhead vs roofline,
    # calibrated to the paper's measured per-token step times (§7: HF-style
    # engines run ~10x off the decode roofline)

    def compute_time(self, batch: int, tokens_per_req: int = 1,
                     ctx_tokens: int = 0) -> float:
        """Step time: max(weight-read, math) + KV-read — captures the
        batch-efficiency curve that makes block sharing pay off (O2):
        weight reads amortize across the batch, so shared blocks serving
        many tenants run at much higher efficiency than per-app slivers."""
        toks = batch * tokens_per_req
        t_math = self.flops_per_token * toks / (PEAK_FLOPS * self.mfu_cap)
        t_weights = self.param_bytes / HBM_BW
        t_kv = batch * ctx_tokens * self.kv_bytes_per_token / HBM_BW
        return max(t_math, t_weights) * self.overhead_factor + t_kv

    def useful_time(self, batch: int, tokens_per_req: int = 1) -> float:
        return self.flops_per_token * batch * tokens_per_req / (
            PEAK_FLOPS * self.mfu_cap)

    def load_time(self) -> float:
        return self.param_bytes / HOST_TO_DEVICE_BW


def kv_cache_bytes(cost: BlockCost, seq_len: int) -> int:
    return cost.kv_bytes_per_token * seq_len


# --- §5.1: the two transfer scenarios -------------------------------------


def t_revisit_owner(cluster: Cluster, d_i: int, d_j: int,
                    new_token_bytes: int, kv_bytes: int) -> float:
    """Request returns to the device holding its KV cache:
    T = D'_req / B_net(i,j) + D_cache / B_mem(j)."""
    return new_token_bytes / cluster.bw(d_i, d_j) + kv_bytes / HBM_BW


def t_move_with_kv(cluster: Cluster, d_i: int, d_j: int, d_k: int,
                   new_token_bytes: int, kv_bytes: int) -> float:
    """Ship KV to a third device k then load it there."""
    return (new_token_bytes / cluster.bw(d_i, d_k)
            + kv_bytes / cluster.bw(d_j, d_k)
            + kv_bytes / HBM_BW)


def t_recalc(cluster: Cluster, d_i: int, d_k: int, full_req_bytes: int,
             kv_flops: float) -> float:
    """Recompute KV on the new device from the full sequence."""
    return full_req_bytes / cluster.bw(d_i, d_k) + kv_flops / PEAK_FLOPS


def best_kv_strategy(cluster: Cluster, d_i: int, owner: Optional[int],
                     d_k: int, new_token_bytes: int, full_req_bytes: int,
                     kv_bytes: int, kv_flops: float):
    """min(transfer-with-KV, recalc) for a non-owner target (§5.1 second
    scenario).  Returns (time, strategy)."""
    t_rec = t_recalc(cluster, d_i, d_k, full_req_bytes, kv_flops)
    if owner is None:
        return t_rec, "recalc"
    t_mv = t_move_with_kv(cluster, d_i, owner, d_k, new_token_bytes, kv_bytes)
    return (t_mv, "transfer") if t_mv < t_rec else (t_rec, "recalc")


def preempt_readmit_strategy(kv_bytes: int, prefix_flops: float,
                             mfu_cap: float = 0.6) -> Tuple[str, float]:
    """§5.1 transfer-vs-recalc applied to single-host preemption: spilling
    a preempted request's pages costs a host-link round trip (out at
    eviction, back at readmission); recalculation replays the prefix
    matmuls at readmission.  Returns (strategy, estimated seconds)."""
    t_spill = 2.0 * kv_bytes / HOST_TO_DEVICE_BW
    t_rec = prefix_flops / (PEAK_FLOPS * mfu_cap)
    return ("spill", t_spill) if t_spill <= t_rec else ("recalc", t_rec)


# --- §5.3: candidate-instance latency estimate -----------------------------


def estimate_latency(cluster: Cluster, *, queue_compute_time: float,
                     compute_time: float, transfer_time: float,
                     device_idle: bool, evict_bytes: int,
                     load_bytes: int) -> float:
    """Latency_{d_c} = T_queue + T_compute + T_transfer + T_load."""
    if device_idle:
        t_load = 0.0  # overlapped with other operations (paper §5.3)
    else:
        t_load = evict_bytes / HBM_BW + load_bytes / HOST_TO_DEVICE_BW
    return queue_compute_time + compute_time + transfer_time + t_load
