"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``kernels/<name>/csrc/`` with a
plain C interface.  ``nvcc`` compiles it for ``sm_90a`` into a shared
library in ``repro_torch/_build/`` (listed in .gitignore), named by the
kernel and a hash of its source and the headers it includes
(``kernels/common/sm90.cuh``), so an edited source is rebuilt and a built
one is reused; ``ctypes`` loads it.  ``build_all`` starts one
``nvcc`` per source at once, so a fresh checkout builds all kernels in
the time of the slowest.

Nothing here runs at import: the CPU tests import every module of the
port, and the CPU has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Iterable

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_loaded: Dict[Path, ctypes.CDLL] = {}


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


def _sources(src: Path) -> list:
    """``src`` and the local headers it includes (``#include "..."``)."""
    src = Path(src)
    found = [src]
    for line in src.read_text().splitlines():
        if line.startswith('#include "'):
            found += _sources(src.parent / line.split('"')[1])
    return found


def library_path(src: Path) -> Path:
    """Named by the kernel and a hash of its source and local headers."""
    digest = hashlib.sha1(b"".join(
        f.read_bytes() for f in _sources(src))).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(src).stem}-{digest}.so"


def _start(src: Path):
    """Start nvcc for ``src`` unless its library exists; returns
    (process, temporary output) or None."""
    if library_path(src).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(nvcc_command(src, Path(tmp), _nvcc()),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp


def _finish(src: Path, started) -> Path:
    out = library_path(src)
    if started is None:
        return out
    proc, tmp = started
    try:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{err}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build(src: Path) -> Path:
    """Compile ``src`` unless its library exists already."""
    return _finish(src, _start(src))


def build_all(sources: Iterable[Path]) -> list:
    """Compile every source not yet built, one ``nvcc`` each, all at once."""
    sources = list(sources)
    started = [_start(s) for s in sources]
    return [_finish(s, st) for s, st in zip(sources, started)]


def load(src: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (if needed) and load ``src``'s library once per process;
    ``bind`` sets the C functions' argument and result types."""
    src = Path(src)
    lib = _loaded.get(src)
    if lib is None:
        lib = ctypes.CDLL(str(build(src)))
        bind(lib)
        _loaded[src] = lib
    return lib
