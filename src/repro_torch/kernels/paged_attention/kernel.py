"""Hand-written CUDA paged decode attention for Hopper, bound with ctypes.

Replaces ``repro.kernels.paged_attention.kernel.paged_attention`` (the
Pallas TPU kernel) and, in the fused decode step, the one-token page
scatter of ``repro.kernels.paged_attention.ops.paged_decode_step``.  The
source is ``csrc/paged_attention.cu`` (design and bound in its header);
``kernels/_build.py`` compiles it with ``nvcc`` for ``sm_90a`` at first
use, from the sources in this package only.

Nothing here imports or builds anything at module import: the CPU tests
import every module of the port.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
HEAD_DIMS = (32, 64, 80, 128, 160)
MAX_GROUP = 16  # query heads per KV head (kMaxG in the source)
SPLIT_TILE = 64  # positions per bf16 tile (kTile): split lengths' multiple
# positions per split block (flash-decoding), fixed from position 0 so a
# row's bits do not depend on the table's width; chosen from chip_smoke.py's
# split sweep on the H100 (PERF.md)
SPLIT_TOKENS = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel since the count was last set to 0; the
# wrapper adds one per launch, and a megastep graph's replay the launches
# it holds (serving/executor.py)
launches = 0

# per device: B * KVH int32 counters, zero between launches (the last split
# block of each row sets its counter back to 0); grown, never shrunk.  Calls
# that share a device must run in one stream order.
_counters: Dict[torch.device, torch.Tensor] = {}


def library_path() -> Path:
    return _build.library_path(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.paged_attention_split_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached for the process."""
    return _build.load(SOURCE, _bind)


def num_splits(pages_per_seq: int, page_size: int,
               split_tokens: int = SPLIT_TOKENS) -> int:
    """Split blocks per (sequence, KV head): from the table's width and the
    page size only, never from B or the lengths (the host reads none)."""
    return -(-pages_per_seq * page_size // split_tokens)


def grid(q, k_pages, block_tables, split_tokens: int = SPLIT_TOKENS):
    """The launch grid (KVH, B, n_splits) for these inputs (the source
    derives the same from the shapes it is given)."""
    _, page_size, KVH, _ = k_pages.shape
    return (KVH, q.shape[0],
            num_splits(block_tables.shape[1], page_size, split_tokens))


def check_inputs(q, k_pages, v_pages, block_tables, lens, k_new=None,
                 v_new=None) -> None:
    """Raise on anything the kernel does not take (shapes, types, devices,
    layouts).  ``lens`` is seq_lens (attend only) or kv_len (the fused
    step, with ``k_new``/``v_new``)."""
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("paged_attention: q (B,Hq,hd), pages (P,page,KVH,hd)")
    B, Hq, hd = q.shape
    _, _, KVH, hd_k = k_pages.shape
    if hd_k != hd or hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {hd} (pages {hd_k}); "
                         f"the kernel takes {HEAD_DIMS}")
    if Hq % KVH or Hq // KVH > MAX_GROUP:
        raise ValueError(f"paged_attention: Hq={Hq}, KVH={KVH}; need KVH | Hq "
                         f"and Hq/KVH <= {MAX_GROUP}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: dtypes {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}; the kernel takes one of "
                        f"{tuple(_DTYPES)} for all three")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or lens.shape != (B,):
        raise ValueError("paged_attention: block_tables (B,n), lengths (B,)")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"paged_attention: block_tables {block_tables.dtype}"
                        f", lengths {lens.dtype}; the kernel takes int32")
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_tables", block_tables), ("lengths", lens)]
    if (k_new is None) != (v_new is None):
        raise ValueError("paged_attention: k_new and v_new come together")
    if k_new is not None:
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if t.shape != (B, KVH, hd):
                raise ValueError(f"paged_attention: {name} "
                                 f"{tuple(t.shape)}, want {(B, KVH, hd)}")
            if t.dtype != q.dtype:
                raise TypeError(f"paged_attention: {name} {t.dtype}; the "
                                f"kernel writes it into {q.dtype} pages")
            tensors.append((name, t))
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention: {name} must be on {q.device} "
                             "(a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    for name, t in tensors[:3] + tensors[5:]:
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must start 16-byte "
                             "aligned (the kernel reads rows in 16-byte loads)")


def _as_int32(t):
    if t.dtype == torch.int32:
        return t.contiguous()
    if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
        raise TypeError(f"paged_attention: lengths and tables must be "
                        f"integers, got {t.dtype}")
    return t.to(torch.int32).contiguous()


def _counter_buffer(device, n: int) -> torch.Tensor:
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = _counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                              device=device)
    return buf


def _launch(q, k_pages, v_pages, block_tables, lens, k_new, v_new,
            split_tokens: int):
    global launches
    if split_tokens <= 0 or split_tokens % SPLIT_TILE:
        raise ValueError(f"paged_attention: split_tokens {split_tokens}; the "
                         f"kernel takes a multiple of {SPLIT_TILE}")
    block_tables, lens = _as_int32(block_tables), _as_int32(lens)
    q = q.contiguous()
    check_inputs(q, k_pages, v_pages, block_tables, lens, k_new, v_new)
    _, Hq, hd = q.shape
    page_size = k_pages.shape[1]
    n = block_tables.shape[1]
    KVH, B, n_splits = grid(q, k_pages, block_tables, split_tokens)
    out = torch.empty_like(q)
    part = None  # the split blocks' fp32 partials (m, l, acc)
    if n_splits > 1:
        part = torch.empty(B * KVH * n_splits * (Hq // KVH) * (hd + 2),
                           dtype=torch.float32, device=q.device)
    counters = _counter_buffer(q.device, B * KVH)
    fused = k_new is not None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = load().paged_attention_split_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), None if fused else lens.data_ptr(),
        k_new.data_ptr() if fused else None,
        v_new.data_ptr() if fused else None,
        lens.data_ptr() if fused else None, out.data_ptr(),
        None if part is None else part.data_ptr(), counters.data_ptr(),
        B, Hq, KVH, hd, page_size, n, split_tokens, 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def paged_attention_cuda(q, k_pages, v_pages, block_tables, seq_lens, *,
                         split_tokens: int = SPLIT_TOKENS):
    """Attend only: launch the kernel on PyTorch's current stream.  int64
    tables and lengths are converted to the int32 the kernel reads.
    Returns (B, Hq, hd) in q's dtype."""
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, None, None,
                   split_tokens)


def paged_decode_cuda(q, k_new, v_new, k_pages, v_pages, block_tables,
                      kv_len, *, split_tokens: int = SPLIT_TOKENS):
    """The fused decode step in one launch: store k_new/v_new (B, KVH, hd)
    at position kv_len of each row's pages (in place), then attend over
    kv_len + 1 positions.  Returns (B, Hq, hd) in q's dtype."""
    return _launch(q, k_pages, v_pages, block_tables, kv_len,
                   k_new, v_new, split_tokens)
