"""Dispatching wrapper and the segment packing helper — the port of
``repro.kernels.batched_lora.ops``.

``impl``: ``auto`` picks by the tensors' device — a CPU tensor goes to the
plain PyTorch version (``ref``), a CUDA tensor to the hand-written CUDA
kernel.  ``cuda`` on a CPU tensor raises, and a CUDA launch that fails
raises: nothing falls back to ``ref`` behind the caller's back.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.batched_lora import kernel
from repro_torch.kernels.batched_lora.ref import batched_lora_ref

IMPLS = ("auto", "ref", "cuda")


def batched_lora(x, w, a, b, tile_groups, *, bt: int = 128,
                 scaling: float = 1.0, impl: str = "auto"):
    """y[t] = x[t] @ w + scaling * (x[t] @ a[g]) @ b[g] with
    g = tile_groups[t // bt].  x: (T, D); w: (D, F); a: (G, D, r);
    b: (G, r, F); tile_groups: (ceil(T / bt),) int32.  Returns (T, F) in
    x's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"batched_lora impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return batched_lora_ref(x, w, a, b, tile_groups, bt=bt,
                                scaling=scaling)
    if not x.is_cuda:
        raise ValueError("batched_lora impl='cuda' needs CUDA tensors; "
                         f"got x on {x.device}")
    return kernel.batched_lora_cuda(x, w, a, b, tile_groups, bt=bt,
                                    scaling=scaling)


def pack_segments(group_ids, bt: int = 128):
    """Pack per-row adapter ids into tile-aligned segments.

    Returns (row_order, tile_groups, padded_len): rows sorted by adapter,
    each adapter segment padded up to a multiple of ``bt`` (padding rows
    reuse the segment's adapter id and are masked out downstream).
    """
    group_ids = np.asarray(group_ids)
    order = np.argsort(group_ids, kind="stable")
    tiles = []
    row_order = []
    for g in np.unique(group_ids):
        rows = order[group_ids[order] == g]
        pad = (-len(rows)) % bt
        row_order.extend(rows.tolist() + [-1] * pad)
        tiles.extend([int(g)] * ((len(rows) + pad) // bt))
    return (np.array(row_order, np.int32), np.array(tiles, np.int32),
            len(row_order))
