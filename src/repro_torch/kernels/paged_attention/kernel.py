"""Hand-written CUDA paged decode attention for Hopper, bound with ctypes.

Replaces ``repro.kernels.paged_attention.kernel.paged_attention`` (the
Pallas TPU kernel).  The source is ``csrc/paged_attention.cu`` (design and
bound in its header); it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, from the sources in
this package only, into ``repro_torch/_build/`` (listed in .gitignore).
The library's file name carries a hash of the source, so an edited source
is rebuilt and a built one is reused.

Nothing here imports or builds anything at module import: the CPU tests
import every module of the port.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "paged_attention.cu"
BUILD_DIR = _PKG.parents[1] / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16  # query heads per KV head (kMaxG in the source)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel since the count was last set to 0; the
# wrapper adds one per launch and nothing else touches it
launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def nvcc_command(src: Path, out: Path, nvcc: str = "nvcc") -> list:
    """The compile line: sm_90a, a shared library with a C interface."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(out), str(src)]


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libpaged_attention-{digest}.so"


def build() -> Path:
    """Compile the library unless this source's build exists already."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(SOURCE, Path(tmp), _nvcc()),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached for the process."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.paged_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_inputs(q, k_pages, v_pages, block_tables, seq_lens) -> None:
    """Raise on anything the kernel does not take (shapes, types, devices,
    layouts)."""
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
            or seq_lens.shape != (B,):
        raise ValueError("paged_attention: block_tables (B,n), seq_lens (B,)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention: {name} must be on {q.device} "
                             "(a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must start 16-byte "
                             "aligned (the kernel reads rows in 16-byte loads)")


def paged_attention_cuda(q, k_pages, v_pages, block_tables, seq_lens):
    """Launch the kernel on PyTorch's current stream.  int64 tables and
    lengths are converted to the int32 the kernel reads.  Returns
    (B, Hq, hd) in q's dtype."""
    global launches
    if block_tables.dtype != torch.int32:
        block_tables = block_tables.to(torch.int32)
    if seq_lens.dtype != torch.int32:
        seq_lens = seq_lens.to(torch.int32)
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    seq_lens = seq_lens.contiguous()
    check_inputs(q, k_pages, v_pages, block_tables, seq_lens)
    B, Hq, hd = q.shape
    _, page_size, KVH, _ = k_pages.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = load().paged_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, Hq, KVH, hd, page_size, block_tables.shape[1],
        1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
