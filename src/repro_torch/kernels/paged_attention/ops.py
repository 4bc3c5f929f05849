"""Dispatching wrapper + page-pool utilities used by the serving engine —
the port of ``repro.kernels.paged_attention.ops``.

``impl``: ``auto`` picks by the tensors' device — a CPU tensor goes to the
plain PyTorch version (``ref``), a CUDA tensor to the hand-written CUDA
kernel.  ``cuda`` on a CPU tensor raises, and a CUDA launch that fails
raises: nothing falls back to ``ref`` behind the caller's back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

IMPLS = ("auto", "ref", "cuda")


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    impl: str = "auto"):
    """q: (B, Hq, hd); k_pages/v_pages: (P, page, KVH, hd); block_tables:
    (B, n) int; seq_lens: (B,) int.  Returns (B, Hq, hd) in q's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"paged_attention impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "ref":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, seq_lens)
    if not q.is_cuda:
        raise ValueError("paged_attention impl='cuda' needs CUDA tensors; "
                         f"got q on {q.device}")
    return kernel.paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                       seq_lens)


def write_token_to_pages(k_pages, v_pages, block_tables, positions, k_new,
                         v_new):
    """Scatter one token per sequence into its page pool, in place (the
    reference returns updated slabs from a donated buffer; here the slabs
    are written directly).

    k_new/v_new: (B, KVH, hd); positions: (B,) absolute token index.
    """
    page_size = k_pages.shape[1]
    rows = torch.arange(block_tables.shape[0], device=block_tables.device)
    page_idx = block_tables[rows, positions // page_size].long()
    slot = (positions % page_size).long()
    k_pages[page_idx, slot] = k_new.to(k_pages.dtype)
    v_pages[page_idx, slot] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def paged_decode_step(q, k_new, v_new, k_pages, v_pages, block_tables,
                      kv_len, *, impl: str = "auto"):
    """One single-token decode step: scatter the new token's K/V into the
    pages (in place), then attend over them at ``kv_len + 1``.

    q/k_new/v_new: (B, H, hd) / (B, KVH, hd); kv_len: (B,) tokens already
    cached.  Returns (o, k_pages, v_pages) with o: (B, H, hd).
    """
    k_pages, v_pages = write_token_to_pages(
        k_pages, v_pages, block_tables, kv_len, k_new, v_new)
    o = paged_attention(q, k_pages, v_pages, block_tables, kv_len + 1,
                        impl=impl)
    return o, k_pages, v_pages
