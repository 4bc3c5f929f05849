"""Hand-written CUDA flash attention forward for Hopper, bound with ctypes.

Replaces ``repro.kernels.flash_attention.kernel.flash_attention_fwd`` (the
Pallas TPU kernel).  The source is ``csrc/flash_attention.cu`` (design and
bound in its header); ``kernels/_build.py`` compiles it with ``nvcc`` for
``sm_90a`` at first use.  Nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import check_window

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 80, 128, 160)
MAX_GROUP = 64  # query heads per KV head (kRows in the source)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel since the count was last set to 0; the
# wrapper adds one per launch and nothing else touches it
launches = 0


def library_path() -> Path:
    return _build.library_path(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached for the process."""
    return _build.load(SOURCE, _bind)


def check_inputs(q, k, v) -> None:
    """Raise on anything the kernel does not take (shapes, types, devices,
    layouts)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q (B,Hq,S,hd), k/v (B,KVH,S,hd)")
    B, Hq, S, hd = q.shape
    Bk, KVH, Sk, hd_k = k.shape
    if (Bk, Sk, hd_k) != (B, S, hd) or S == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k/v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    if Hq % KVH or Hq // KVH > MAX_GROUP:
        raise ValueError(f"flash_attention: Hq={Hq}, KVH={KVH}; need KVH | Hq "
                         f"and Hq/KVH <= {MAX_GROUP}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes one of "
                        f"{tuple(_DTYPES)} for all three")
    vec = 16 // q.element_size()  # elements per 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on {q.device} "
                             "(a CUDA device)")
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             "head dim and 16-byte-aligned rows (strides "
                             f"{t.stride()})")


def flash_attention_cuda(q, k, v, *, causal: bool = True, sm_scale=None,
                         window: int = 0):
    """Launch the kernel on PyTorch's current stream.  q (B, Hq, S, hd) and
    k/v (B, KVH, S, hd) may be strided views; the output has q's shape,
    dtype and memory layout (``torch.empty_like``).  ``window`` as in
    ``check_window``."""
    global launches
    check_window(causal, window)
    check_inputs(q, k, v)
    B, Hq, S, hd = q.shape
    KVH = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = load().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, KVH, S, hd, *strides, float(sm_scale), int(bool(causal)),
        int(window), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
