"""Per-device cost of one traced step — the port of
``repro.launch.hlo_analysis``, which keeps its file name so the module map
stays one to one.

The reference parses the compiled HLO text of one SPMD program.  PyTorch
has no HLO, so this module ports the role, not the parser: ``DeviceCost``
is a dispatch mode (``torch.distributed.tensor.debug.CommDebugMode``, whose
collective counts it keeps) that sees every op a step runs on each
device's **local shards**.  A DTensor op is handed back to DTensor (the
mode returns ``NotImplemented``), which runs it as ops on the local
tensors and collectives between them, and those the mode counts:

  - FLOPs from ``torch.utils.flop_counter``'s formulas (the ones
    ``FlopCounterMode`` uses), over the local shapes.  Counted from
    outside DTensor, the same formulas give the *global* product;
  - bytes: every input each op reads and every output it writes, once per
    op, views and allocations excluded.  This is an **unfused upper
    bound**: the reference's ``bytes`` is fusion-adjusted, this is not;
  - collective bytes by kind (the reference's names: ``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``), each
    collective's input bytes, and their sum.

The ops DTensor runs on ``FakeTensor``s to propagate its shardings are not
counted.  The reference's record fields with no counterpart here are left
out rather than invented: ``layout_bytes`` and ``elementwise_bytes`` (CPU
legalization and unfused-elementwise tallies of XLA's CPU backend), the
compiled program's ``memory.temp_bytes`` and ``alias_bytes``, and
``compile_s`` (nothing is compiled).  ``lower_s`` becomes ``trace_s``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# collective op name -> the reference's kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# ops that move no bytes: allocations without a fill, and bookkeeping
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
         "sym_size", "sym_stride", "sym_numel", "is_same_size"}


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class DeviceCost(CommDebugMode):
    """Per-device FLOPs, bytes and collective bytes of the ops run inside
    it (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_read = 0.0
        self.bytes_written = 0.0
        self.collective_bytes: Dict[str, float] = defaultdict(float)
        self.local_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator) or any(
                issubclass(t, DTensor) for t in types):
            return super().__torch_dispatch__(func, types, args, kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(x, FakeTensor) for x in ins):
            return out  # DTensor's sharding propagation, not the step
        self.local_ops += 1
        name = func.overloadpacket.__name__
        if name in _COLLECTIVES:
            self.collective_bytes[_COLLECTIVES[name]] += sum(
                _nbytes(x) for x in ins)
            return out
        if func.overloadpacket in flop_registry:
            self.flops += flop_registry[func.overloadpacket](
                *args, **(kwargs or {}), out_val=out)
        if name not in _FREE and not _is_view(func):
            self.bytes_read += sum(_nbytes(x) for x in ins)
            self.bytes_written += sum(_nbytes(x) for x in _tensors(out))
        return out

    def totals(self) -> Dict[str, object]:
        """Per-device totals, in the reference's ``hlo_per_device`` keys
        where they have a counterpart."""
        coll = dict(self.collective_bytes)
        return {
            "flops": self.flops,
            "bytes": self.bytes_read + self.bytes_written,  # unfused bound
            "bytes_read": self.bytes_read,
            "bytes_written": self.bytes_written,
            "collectives": coll,
            "collective_bytes": sum(coll.values()),
            "collective_counts": {str(k).split(".")[-1]: v for k, v in
                                  self.get_comm_counts().items()},
            "local_ops": self.local_ops,
            "bytes_note": "unfused upper bound: each op's inputs read and "
                          "outputs written once",
        }


def local_bytes(tree) -> int:
    """Bytes of this device's shards of every tensor in ``tree``."""
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if isinstance(t, DTensor) else t)
    return total
