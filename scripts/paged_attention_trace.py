#!/usr/bin/env python3
"""Per-block phase times of the paged-attention kernel's bf16 body, on one
NVIDIA GPU.

    python3 scripts/paged_attention_trace.py [--splits 64 128 256 512]

Builds a copy of ``csrc/paged_attention.cu`` in which thread 0 of every
block writes the GPU's ``%globaltimer`` (ns) at the edges of its phases
into a ``__device__`` array: entry, past the dead-split exit (``live``),
first tile landed (``tile0``), last tile computed (``loop``), the four
warps merged (``merge``), past the cross-block counter (``atomic``) and,
in the block that combines its row's splits, the end of the combine.  The
copy is compiled into ``repro_torch/_build/`` and driven through the
kernel's own wrapper.  For each split length and each of chip_smoke's
engine decode batch (``main_path``), long_prefill decode group
(``main_long_base_B3``) and ``long`` shape it prints one JSON line: the
kernel's time (``chip_smoke.time_ms``, L2 flushed), the trace's span, and
the p50 and max over live blocks of each phase's duration and of the
blocks' start offsets.  The instrumented kernel is timed, not the
committed one: the stores cost a little.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pa_kernel  # noqa: E402

PHASES = ("start", "live", "tile0", "loop", "merge", "atomic", "combined")
TRACE = '''
__device__ unsigned long long g_trace[1 << 16][8];
__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TR(k)                                                            \\
  if (threadIdx.x == 0)                                                  \\
    g_trace[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +          \\
            blockIdx.x][k] = trace_now();
namespace {'''
READ = '''
extern "C" int pa_trace_copy(void* dst, size_t bytes) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, bytes);
}
extern "C" int pa_trace_reset() {
  void* p;
  cudaGetSymbolAddress(&p, g_trace);
  return (int)cudaMemset(p, 0, sizeof(g_trace));
}
'''


def instrumented_source() -> str:
    """The kernel source with TR(k) stores at the phase edges; raises if
    an edge is not found (the source changed)."""
    src = pa_kernel.SOURCE.read_text()
    header = str(ROOT / "src/repro_torch/kernels/common/sm90.cuh")
    body = src.index("paged_attention_tc_kernel(const Params p) {")
    edges = [  # (text the store goes after, k, only after the bf16 body)
        ("  const int h = blockIdx.x;\n", 0, True),
        ("  if (split >= sp.n_live) return;\n", 1, True),
        ("every warp is done with tile it - 1\n", "    if (it == 0) { TR(2) }\n",
         True),
        ("    acc_s[i] = A;\n  }\n", 4, True),
        ("  __syncthreads();\n  if (!last) return;\n", 5, False),
    ]
    for anchor, k, in_body in edges:
        at = src.index(anchor, body if in_body else 0) + len(anchor)
        src = src[:at] + (k if isinstance(k, str) else f"  TR({k})\n") \
            + src[at:]
    loop_end = src.index("  // merge the four warps'", body)
    src = src[:loop_end] + "  TR(3)\n" + src[loop_end:]
    end = ("    if (i < rows) out[i] = from_float<T>(A[j] / fmaxf(L_s[i / HD], "
           "1e-30f));\n  }\n")
    at = src.index(end) + len(end)
    src = src[:at] + "  TR(6)\n" + src[at:]
    src = src.replace("namespace {", TRACE, 1)
    src = src.replace('#include "../../common/sm90.cuh"',
                      f'#include "{header}"')
    return src + READ


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", type=int, nargs="+",
                    default=[pa_kernel.SPLIT_TOKENS])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("paged_attention_trace: no CUDA device")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "paged_attention_trace.cu"
    lib_path = _build.BUILD_DIR / "libpaged_attention_trace.so"
    src.write_text(instrumented_source())
    subprocess.run(_build.nvcc_command(src, lib_path, _build._nvcc()),
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    pa_kernel._bind(lib)
    lib.pa_trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    pa_kernel.load = lambda: lib
    smi = chip_smoke.nvidia_smi()
    cases = chip_smoke.paged_attention_cases(get_config(chip_smoke.MODEL))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for split in args.splits:
        for name in ("main_path", "main_long_base_B3", "long"):
            B, Hq, KVH, hd, nps, lens, pages = cases[name]
            q, k, v, tables, seq = chip_smoke.kernel_inputs(
                B, Hq, KVH, hd, nps, lens, pages, torch.bfloat16, seed=0)

            def call():
                return pa_kernel.paged_attention_cuda(
                    q, k, v, tables, seq, split_tokens=split)

            ms = chip_smoke.time_ms(call, 20, flush)
            lib.pa_trace_reset()
            flush.zero_()
            torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
            call()
            torch.cuda.synchronize()
            n = KVH * B * pa_kernel.num_splits(nps, chip_smoke.PAGE, split)
            buf = np.zeros((1 << 16, 8), np.uint64)
            lib.pa_trace_copy(buf.ctypes.data, buf.nbytes)
            tr = buf[:n].astype(np.int64)
            t0 = tr[tr[:, 0] > 0, 0].min()
            rel = np.where(tr > 0, tr - t0, -1) / 1e3  # us from the first
            live = rel[rel[:, 1] >= 0]
            row = {"case": name, "split_tokens": split, "ms": ms,
                   "blocks": int(n), "live_blocks": len(live),
                   "span_us": float(rel.max()),
                   "start_us": [float(np.median(live[:, 0])),
                                float(live[:, 0].max())]}
            for a in range(5):  # over the blocks that reached both edges
                both = live[(live[:, a] >= 0) & (live[:, a + 1] >= 0)]
                if len(both):
                    d = both[:, a + 1] - both[:, a]
                    row[f"{PHASES[a]}->{PHASES[a + 1]}_us"] = [
                        float(np.median(d)), float(d.max())]
            last = live[live[:, 6] >= 0]
            if len(last):
                d = last[:, 6] - last[:, 5]
                row["combine_us"] = [float(np.median(d)), float(d.max())]
            row["card"] = smi
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
