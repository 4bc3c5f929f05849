"""KV manager: slot-based paged KV pools shared across chains, with
preemption (DESIGN.md §2) — the port of ``repro.serving.kv_pool``.

One ``KVPool`` per (kv_heads, head_dim) signature holds two page slabs
``(num_pages, page_size, KVH, hd)`` for K and V on the pool's device.  Every
attention-bearing chain step of every in-flight request owns a run of page
ids (a *slot*) carved out of the same slab, so requests from different apps
— and the shared foundation blocks they batch on — draw from one memory
budget.

Writes go into the slabs in place (``index_put_``): the reference donates
its slabs to each update for the same effect.

Page 0 is reserved as a scratch ("trash") page: group batching pads ragged
block tables with it, and masked lanes of padded rows never read past
their own pages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

TRASH_PAGE = 0  # reserved scratch page for padded table entries


@dataclass
class KVSlot:
    """A sequence's page run inside one pool for one attention block."""
    pages: List[int]
    max_len: int  # capacity in tokens = len(pages) * page_size


class KVPool:
    """Paged K/V slab with a free list and per-slot bookkeeping."""

    def __init__(self, num_pages: int, page_size: int, kv_heads: int,
                 head_dim: int, dtype=torch.bfloat16, device="cuda",
                 metrics=None, name: str = ""):
        if num_pages < 2:
            raise ValueError("pool needs at least the trash page + one slot")
        self.page_size = page_size
        self.num_pages = num_pages
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.device = torch.device(device)
        shape = (num_pages, page_size, kv_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        # page 0 reserved (TRASH_PAGE); never handed out
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.slots: Dict[Tuple[int, int], KVSlot] = {}  # (rid, step) -> slot
        self.alloc_count = 0
        self.free_count = 0
        # observability (DESIGN.md §8): used/free pages as gauges, tagged
        # by pool signature so per-signature pressure is visible
        self.metrics = metrics
        self.name = name or f"{kv_heads}x{head_dim}"
        self._update_gauges()

    def _update_gauges(self):
        if self.metrics is not None:
            self.metrics.set_gauge(f"kv_used_pages[{self.name}]",
                                   self.used_pages)
            self.metrics.set_gauge(f"kv_free_pages[{self.name}]",
                                   len(self._free))

    # -- accounting ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def page_bytes(self) -> int:
        """K+V bytes held by one page."""
        return 2 * (self.page_size * self.kv_heads * self.head_dim
                    * self.k_pages.element_size())

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return max(1, -(-tokens // self.page_size))

    def can_fit(self, tokens: int, n_slots: int) -> bool:
        return self.pages_needed(tokens) * n_slots <= len(self._free)

    # -- slot lifecycle -----------------------------------------------------

    def alloc(self, rid: int, step: int, tokens: int) -> KVSlot:
        """Reserve enough pages for ``tokens`` total tokens (prompt + full
        generation budget — allocation happens once, at admission)."""
        n = self.pages_needed(tokens)
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        slot = KVSlot(pages=pages, max_len=n * self.page_size)
        self.slots[(rid, step)] = slot
        self.alloc_count += n
        self._update_gauges()
        return slot

    def free(self, rid: int, step: int):
        slot = self.slots.pop((rid, step))
        self._free.extend(slot.pages)
        self.free_count += len(slot.pages)
        self._update_gauges()

    def free_request(self, rid: int):
        for key in [k for k in self.slots if k[0] == rid]:
            self.free(*key)

    # -- batched table construction ----------------------------------------

    def block_table(self, keys: List[Tuple[int, int]]) -> np.ndarray:
        """Stack the slots' page runs into a (B, n) int32 table, padding
        ragged rows with the trash page (reads beyond kv_len are masked)."""
        rows = [self.slots[k].pages for k in keys]
        width = max(len(r) for r in rows)
        table = np.full((len(rows), width), TRASH_PAGE, np.int32)
        for i, r in enumerate(rows):
            table[i, :len(r)] = r
        return table

    def _page_index(self, pages: List[int]) -> torch.Tensor:
        return torch.tensor(pages, dtype=torch.long, device=self.device)

    # -- prefill scatter ----------------------------------------------------

    def write_prefill(self, rid: int, step: int, k_r, v):
        """Write a prefill's raw K/V (1, S, KVH, hd) into the slot's pages,
        in place."""
        slot = self.slots[(rid, step)]
        S = k_r.shape[1]
        npages = self.pages_needed(S)
        pad = npages * self.page_size - S
        if pad:
            k_r = torch.nn.functional.pad(k_r, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kp = k_r[0].reshape(npages, self.page_size, *k_r.shape[2:])
        vp = v[0].reshape(npages, self.page_size, *v.shape[2:])
        idx = self._page_index(slot.pages[:npages])
        self.k_pages[idx] = kp.to(self.k_pages.dtype)
        self.v_pages[idx] = vp.to(self.v_pages.dtype)


# ---------------------------------------------------------------------------
# manager: the pools as one coordinated memory plane
# ---------------------------------------------------------------------------


@dataclass
class KVSnapshot:
    """Host-side copy of a preempted request's pages (spill strategy).

    Keyed by (pool signature, chain step); each value is the (K, V) page
    stack exactly as it sat in the device slabs, as CPU tensors (pinned
    when the pool lives on a CUDA device)."""
    pages: Dict[Tuple[Tuple[int, int], int],
                Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=dict)
    kv_bytes: int = 0


class KVManager:
    """Coordinates one ``KVPool`` per KV signature under a shared budget:
    admission planning (can a request's whole slot footprint fit *now*),
    allocation bookkeeping, and slot preemption/restore."""

    def __init__(self, page_size: int, num_pages: int, dtype=torch.bfloat16,
                 device="cuda", metrics=None, tracer=None):
        self.page_size = page_size
        self.num_pages = num_pages
        self.dtype = dtype
        self.device = torch.device(device)
        self.metrics = metrics  # shared registry: per-pool page gauges
        self.tracer = tracer    # spill/restore lifecycle events (§8)
        self.pools: Dict[Tuple[int, int], KVPool] = {}

    def pool_for(self, block) -> Tuple[Tuple[int, int], KVPool]:
        """The (signature key, pool) a block's KV slots live in; pools are
        created lazily on first use of a signature."""
        key = block.kv_signature
        pool = self.pools.get(key)
        if pool is None:
            pool = self.pools[key] = KVPool(self.num_pages, self.page_size,
                                            key[0], key[1], dtype=self.dtype,
                                            device=self.device,
                                            metrics=self.metrics)
        return key, pool

    # -- admission planning --------------------------------------------------

    def plan(self, steps) -> Dict[Tuple[int, int], int]:
        """Slots needed per pool signature for one request's resolved chain
        steps (``[(block, adapters), ...]``)."""
        need: Dict[Tuple[int, int], int] = {}
        for block, _ in steps:
            if block.has_kv:
                key, _ = self.pool_for(block)
                need[key] = need.get(key, 0) + 1
        return need

    def can_admit(self, steps, tokens: int) -> bool:
        """Whole-lifetime footprint check: every slot the request will ever
        need (``tokens`` = prompt + full generation budget) fits now."""
        return all(self.pools[k].can_fit(tokens, n)
                   for k, n in self.plan(steps).items())

    # -- request lifecycle ---------------------------------------------------

    def free_request(self, rid: int) -> None:
        for pool in self.pools.values():
            pool.free_request(rid)

    def kv_bytes(self, rid: int) -> int:
        """Device bytes currently pinned by a request across all pools."""
        total = 0
        for pool in self.pools.values():
            for (r, _), slot in pool.slots.items():
                if r == rid:
                    total += len(slot.pages) * pool.page_bytes
        return total

    # -- preemption ----------------------------------------------------------

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host
        return t.clone()

    def spill(self, rid: int) -> KVSnapshot:
        """Copy the request's pages to host memory and free its slots."""
        snap = KVSnapshot()
        for key, pool in self.pools.items():
            for r, step in [k for k in pool.slots if k[0] == rid]:
                slot = pool.slots[(r, step)]
                idx = pool._page_index(slot.pages)
                snap.pages[(key, step)] = (self._to_host(pool.k_pages[idx]),
                                           self._to_host(pool.v_pages[idx]))
                snap.kv_bytes += len(slot.pages) * pool.page_bytes
                pool.free(r, step)
        if self.tracer is not None:
            self.tracer.event(rid, "spill", kv_bytes=snap.kv_bytes,
                              slots=len(snap.pages))
        return snap

    def restore(self, rid: int, snap: KVSnapshot, tokens: int) -> None:
        """Re-allocate slots (possibly on different pages) and write the
        spilled page contents back into the device slabs, in place."""
        for (key, step), (k_h, v_h) in snap.pages.items():
            pool = self.pools[key]
            slot = pool.alloc(rid, step, tokens)
            if len(slot.pages) != k_h.shape[0]:
                raise RuntimeError("restore allocated a different page count "
                                   "than was spilled")
            idx = pool._page_index(slot.pages)
            pool.k_pages[idx] = k_h.to(pool.device, pool.k_pages.dtype)
            pool.v_pages[idx] = v_h.to(pool.device, pool.v_pages.dtype)
        if self.tracer is not None:
            self.tracer.event(rid, "restore", kv_bytes=snap.kv_bytes,
                              slots=len(snap.pages))
