"""Production mesh builders — the port of ``repro.launch.mesh``.

Defined as FUNCTIONS so importing this module never touches a process
group.  A mesh is a ``DeviceMesh`` with named dims, and it needs a default
process group of as many ranks as it has devices:

- the production meshes, (16, 16) ``data``/``model`` = 256 GPUs, or
  (2, 16, 16) ``pod``/``data``/``model`` = 512 GPUs, are built in one
  process under torch's ``fake`` backend (``init_fake_process_group``),
  whose collectives move nothing: the dry-run traces a cell on them with
  its tensors on the ``meta`` device, as the reference builds its 512
  devices on a forced CPU host;
- ``make_local_mesh`` is (1, n) over the ranks of the process group the
  caller set up for real (``init_local_process_group``: one rank on one
  card, ``nccl``; ``gloo`` on the CPU).

On H100 servers of 8 GPUs joined by NVLink, a 16-wide ``model`` axis spans
two servers: its collectives cross ``INTER_SERVER_BW``, the link between
servers, where an 8-wide axis would stay on ``INTRA_SERVER_BW``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.serving.cluster import (  # noqa: F401 (re-exported)
    HBM_BW,
    INTER_SERVER_BW,
    INTRA_SERVER_BW,
    PEAK_FLOPS,
)

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def production_world_size(*, multi_pod: bool = False) -> int:
    shape = (MULTI_POD if multi_pod else SINGLE_POD)[0]
    n = 1
    for s in shape:
        n *= s
    return n


def init_fake_process_group(world_size: int) -> None:
    """A one-process default group of ``world_size`` ranks (this process is
    rank 0) under torch's ``fake`` backend, whose collectives return
    without moving data: the production meshes are built on it for the
    dry-run, never for a run that computes values.  Importing
    ``torch.testing._internal.distributed.fake_pg`` registers the backend
    (the only place torch keeps it)."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)


def init_local_process_group(backend: str) -> None:
    """A real one-rank default group (rank 0 of 1) over an in-process
    store: ``nccl`` on the card (device 0), ``gloo`` on the CPU.  Raises if
    the group cannot be set up."""
    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 GPUs; 2 pods = 512 GPUs multi-pod.  The default process
    group must have that many ranks (``init_fake_process_group``)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_local_mesh():
    """(1, n) over this process group's ranks (the card's run: (1, 1))."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    backend = dist.get_backend()
    device = "cuda" if backend == "nccl" else "cpu"
    return init_device_mesh(device, (1, n), mesh_dim_names=("data", "model"))
