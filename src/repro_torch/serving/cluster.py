"""Cluster model: servers, devices, links — the substrate the scheduler and
agents run against; the port of ``repro.serving.cluster``.

The control plane (scheduler / agents / KV registry) is the REAL
implementation; time advances through the cost model (paper §5.1/§5.3
formulas).  The reference instantiates them with TPU v5e constants; this
copy carries NVIDIA H100 SXM ones, so every time the simulator reports is
modeled from these constants, not measured.  The control-plane classes
back the real engine (``repro_torch.serving.engine``) and the
discrete-event evaluation (``repro_torch.serving.simulator``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

# hardware constants (per device), NVIDIA H100 SXM5 unless noted; "data
# sheet" is NVIDIA's H100 Tensor Core GPU data sheet, SXM column
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s (data sheet: 1,979 TFLOPS
#                            with sparsity, half of it dense)
HBM_BW = 3.35e12           # B/s HBM3 (data sheet: 3.35 TB/s)
INTRA_SERVER_BW = 450e9    # B/s per direction, NVLink 4 inside a server
#                            (data sheet: 900 GB/s both directions together)
INTER_SERVER_BW = 12.5e9   # B/s between servers: the paper's 100 Gbps
#                            network (paper §7.1)
HOST_TO_DEVICE_BW = 64e9   # B/s per direction, PCIe Gen5 x16 (data sheet:
#                            128 GB/s both directions together)
DEVICE_MEMORY = 80e9       # bytes of HBM3 (data sheet: 80 GB)


@dataclass
class Device:
    device_id: int
    server_id: int
    memory: int = DEVICE_MEMORY
    # dynamic state
    resident_blocks: Dict[str, int] = field(default_factory=dict)  # id -> bytes
    kv_bytes: int = 0
    busy_until: float = 0.0
    busy_time: float = 0.0
    useful_flop_time: float = 0.0  # for SM-efficiency

    def used(self) -> int:
        return sum(self.resident_blocks.values()) + self.kv_bytes

    def free(self) -> int:
        return self.memory - self.used()


@dataclass
class Cluster:
    n_servers: int
    devices_per_server: List[int]
    devices: List[Device] = field(default_factory=list)

    def __post_init__(self):
        did = 0
        for sid, n in enumerate(self.devices_per_server):
            for _ in range(n):
                self.devices.append(Device(did, sid))
                did += 1

    def bw(self, a: int, b: int) -> float:
        """Network bandwidth between two devices."""
        da, db = self.devices[a], self.devices[b]
        if a == b:
            return HBM_BW
        if da.server_id == db.server_id:
            return INTRA_SERVER_BW
        return INTER_SERVER_BW

    def same_server(self, a: int, b: int) -> bool:
        return self.devices[a].server_id == self.devices[b].server_id


def paper_cluster() -> Cluster:
    """Paper §7.1: four servers — 2x 2 devices + 2x 4 devices (12 total)."""
    return Cluster(4, [2, 2, 4, 4])
