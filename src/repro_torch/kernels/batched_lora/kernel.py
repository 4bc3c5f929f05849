"""Hand-written CUDA segment-aligned batched LoRA for Hopper, bound with
ctypes.

Replaces ``repro.kernels.batched_lora.kernel.batched_lora_matmul`` (the
Pallas TPU kernel).  The source is ``csrc/batched_lora.cu`` (design and
bound in its header); ``kernels/_build.py`` compiles it with ``nvcc`` for
``sm_90a`` at first use.  Nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "batched_lora.cu"
ROW_TILE = 64  # rows per thread block (kBM in the source): bt's multiple
MAX_RANK = 64  # kMaxR in the source
# calls with T <= SPLIT_T take the split-D path, longer ones the tiled one:
# on the H100 the q projection (D = F = 2,048) ran faster split at T = 128
# and 256 and tiled at 512 and 1,024 (chip_smoke.py's split sweep, PERF.md)
SPLIT_T = 256
D_CHUNK = 128  # kKC: the D chunk of the summation order
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel since the count was last set to 0; the
# wrapper adds one per launch, and a megastep graph's replay the launches
# it holds (serving/executor.py)
launches = 0


def library_path() -> Path:
    return _build.library_path(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.batched_lora_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached for the process."""
    return _build.load(SOURCE, _bind)


def check_inputs(x, w, a, b, tile_groups, bt: int) -> None:
    """Raise on anything the kernel does not take (shapes, types, devices,
    layouts)."""
    if x.dim() != 2 or w.dim() != 2 or a.dim() != 3 or b.dim() != 3:
        raise ValueError("batched_lora: x (T,D), w (D,F), a (G,D,r), "
                         "b (G,r,F)")
    T, D = x.shape
    F = w.shape[1]
    G, _, r = a.shape
    if w.shape[0] != D or a.shape[1] != D or b.shape != (G, r, F) or T == 0:
        raise ValueError(f"batched_lora: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if not 0 < r <= MAX_RANK:
        raise ValueError(f"batched_lora: rank {r}; the kernel takes 1.."
                         f"{MAX_RANK}")
    if bt <= 0 or bt % ROW_TILE:
        raise ValueError(f"batched_lora: bt={bt}; the kernel takes a "
                         f"multiple of {ROW_TILE}")
    if tile_groups.shape != (-(-T // bt),) or tile_groups.dtype != torch.int32:
        raise ValueError("batched_lora: tile_groups (ceil(T/bt),) int32, got "
                         f"{tuple(tile_groups.shape)} {tile_groups.dtype}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (w, a, b)):
        raise TypeError(f"batched_lora: dtypes {x.dtype}/{w.dtype}/{a.dtype}/"
                        f"{b.dtype}; the kernel takes one of "
                        f"{tuple(_DTYPES)} for all four")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b),
                    ("tile_groups", tile_groups)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"batched_lora: {name} must be on {x.device} "
                             "(a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"batched_lora: {name} must be contiguous")
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16 or (t.shape[1] * t.element_size()) % 16:
            raise ValueError(f"batched_lora: {name} needs 16-byte-aligned "
                             "rows (the kernel reads them in 16-byte loads)")


def batched_lora_cuda(x, w, a, b, tile_groups, *, bt: int = 128,
                      scaling: float = 1.0, split=None):
    """Launch the kernel on PyTorch's current stream.  Returns (T, F) in
    x's dtype.  ``split`` picks the path: None takes the split-D path for
    T <= SPLIT_T and the tiled one above; True or False forces one (both
    give the same bits, so this only moves time)."""
    global launches
    check_inputs(x, w, a, b, tile_groups, bt)
    T, D = x.shape
    F = w.shape[1]
    r = a.shape[2]
    if split is None:
        split = T <= SPLIT_T
    out = torch.empty((T, F), dtype=x.dtype, device=x.device)
    work = None  # the split path's fp32 partial sums, per D chunk
    if split:
        work = torch.empty(-(-D // D_CHUNK) * T * (F + r),
                           dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = load().batched_lora_fwd(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        tile_groups.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), T, D, F, r, bt,
        float(scaling), int(bool(split)), _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"batched_lora kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out
