#!/usr/bin/env python3
"""Time this checkout's CUDA kernels (paged attention, flash attention,
batched LoRA) against another checkout's, on one NVIDIA GPU, in one
process.

    python3 scripts/kernel_ab.py --base DIR [--out FILE]

``DIR`` is an unpacked earlier commit of this repository (for example
``git archive <commit> | tar -x -C scratch/base``).  Both trees' kernel
sources are built with ``nvcc`` at once, and every bf16 shape that
``chip_smoke.py``'s main paths give the kernels is timed base, this
tree, this tree, base, with the L2 cache flushed before each call
(``chip_smoke.time_ms``): paged attention at the engine's decode batch,
the long_prefill decode groups and the long shape, attend only, and also
the base tree's decode step (``write_token_to_pages``, then its kernel)
against this tree's one fused launch where this tree has it; flash at
each prefill group and the recompute prefill; LoRA at each app-lora
prefill and decode width.  Both outputs are also compared: the kernels
must agree with each other to the kernels' bf16 tolerances.  Prints one
JSON line per shape and writes them all to ``FILE``.
"""
import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.batched_lora import kernel as lora_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    write_token_to_pages,
)

SOURCES = {"paged_attention": "paged_attention/csrc/paged_attention.cu",
           "flash_attention": "flash_attention/csrc/flash_attention.cu",
           "batched_lora": "batched_lora/csrc/batched_lora.cu"}
RECOMPUTE_S = 1468  # the long_prefill phase's recompute length (PERF.md)
ITERS = 20


class Lib:
    """One tree's build of one kernel source, called the way its own
    wrapper calls it (the LoRA entry point gained a ``split`` argument;
    a source without it picks its path from T itself; the paged entry
    point became ``paged_attention_split_fwd``, with the fused step)."""

    def __init__(self, src: Path, out_dir: Path, tag: str):
        self.src = src
        self.path = out_dir / f"lib{src.stem}-{tag}.so"
        text = src.read_text()
        self.takes_split = "int split" in text
        self.fused = "paged_attention_split_fwd" in text

    def start(self):
        cmd = _build.nvcc_command(self.src, self.path, _build._nvcc())
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def load(self):
        self.lib = ctypes.CDLL(str(self.path))
        if self.src.stem == "paged_attention":
            if self.fused:
                pa_kernel._bind(self.lib)
            else:
                fn = self.lib.paged_attention_fwd
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
        elif self.src.stem == "flash_attention":
            fa_kernel._bind(self.lib)
        else:
            fn = self.lib.batched_lora_fwd
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                           + [ctypes.c_float]
                           + [ctypes.c_int] * (2 if self.takes_split else 1)
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int


def paged_call(lib, q, k, v, tables, lens, k_new=None, v_new=None):
    """Attend over ``lens`` (or, with k_new/v_new, the fused step at
    kv_len = ``lens``).  A fused source runs through this tree's wrapper
    (its workspace and counters) on ``lib``; an older one through its own
    entry point, which attends only."""
    if lib.fused:
        real = pa_kernel.load
        pa_kernel.load = lambda: lib.lib
        try:
            if k_new is None:
                return pa_kernel.paged_attention_cuda(q, k, v, tables, lens)
            return pa_kernel.paged_decode_cuda(q, k_new, v_new, k, v, tables,
                                               lens)
        finally:
            pa_kernel.load = real
    assert k_new is None, "the base source has no fused step"
    B, Hq, hd = q.shape
    _, page, KVH, _ = k.shape
    out = torch.empty_like(q)
    rc = lib.lib.paged_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), B, Hq, KVH, hd, page,
        tables.shape[1], 1.0 / math.sqrt(hd), 1,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{lib.path.name}: CUDA error {rc}")
    return out


def flash_call(lib, q, k, v, out):
    B, Hq, S, hd = q.shape
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
        k.shape[1], S, hd, *strides, 1.0 / math.sqrt(hd), 1, 1,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{lib.path.name}: CUDA error {rc}")


def lora_call(lib, x, w, a, b, tiles, out, work, split):
    """``split`` reaches a source that takes it; an older source picks its
    path from T itself."""
    T, D = x.shape
    F, r = w.shape[1], a.shape[2]
    args = [x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            tiles.data_ptr(), out.data_ptr(), work.data_ptr(), T, D, F, r,
            chip_smoke.LORA_BT, 1.0] + ([int(split)] if lib.takes_split
                                        else [])
    rc = lib.lib.batched_lora_fwd(*args, 1,
                                  torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{lib.path.name}: CUDA error {rc}")


def abba(base_fn, new_fn, flush):
    """base, new, new, base: the mean of each side's two readings."""
    t = [chip_smoke.time_ms(fn, ITERS, flush)
         for fn in (base_fn, new_fn, new_fn, base_fn)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "kernel_ab.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    smi = chip_smoke.nvidia_smi()
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {(name, tag): Lib(tree / "src/repro_torch/kernels" / rel, out_dir,
                             tag)
            for name, rel in SOURCES.items()
            for tag, tree in (("base", args.base.resolve()), ("new", ROOT))}
    procs = {key: lib.start() for key, lib in libs.items()}
    for key, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {libs[key].src}:\n{err}")
        libs[key].load()

    cfg = get_config(chip_smoke.MODEL)
    paged_cases = {name: case for name, case in
                   chip_smoke.paged_attention_cases(cfg).items()
                   if name.startswith("main") or name == "long"}
    flash_cases, lora_cases = chip_smoke.main_path_cases(
        cfg, (chip_smoke.traffic(cfg), chip_smoke.long_traffic(cfg)))
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    flash_cases[f"main_recalc_B1_S{RECOMPUTE_S}"] = (1, H, KVH, RECOMPUTE_S,
                                                     hd, True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator("cuda").manual_seed(0)
    rows = []

    def emit(row):
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)

    base, new = libs["paged_attention", "base"], libs["paged_attention", "new"]
    tol = chip_smoke.TOL[torch.bfloat16]
    for case, (B, Hq, KV, d, nps, seq_lens, pages) in paged_cases.items():
        q, k, v, tables, lens = chip_smoke.kernel_inputs(
            B, Hq, KV, d, nps, seq_lens, pages, torch.bfloat16, seed=0)
        k_new, v_new, kv_len = chip_smoke.decode_inputs(q, k, lens,
                                                        seed=0)
        o = {}
        base_ms, new_ms, t = abba(
            lambda: o.__setitem__("base", paged_call(base, q, k, v, tables,
                                                     lens)),
            lambda: o.__setitem__("new", paged_call(new, q, k, v, tables,
                                                    lens)), flush)
        diff = float((o["base"].float() - o["new"].float()).abs().max())
        if diff > tol:
            raise RuntimeError(f"paged {case}: trees differ by {diff}")
        row = {"kernel": "paged_attention", "case": case, "B": B,
               "seq_len_max": max(seq_lens), "base_ms": base_ms,
               "new_ms": new_ms, "readings_ms": t,
               "new_over_base": new_ms / base_ms, "max_abs_diff": diff}
        if new.fused and not base.fused:
            # the decode step: base scatter + attend against one launch,
            # each on its own copy of the pages
            kb, vb, kn, vn = k.clone(), v.clone(), k.clone(), v.clone()

            def base_step():
                write_token_to_pages(kb, vb, tables, kv_len, k_new, v_new)
                o["base_step"] = paged_call(base, q, kb, vb, tables,
                                            kv_len + 1)

            def new_step():
                o["new_step"] = paged_call(new, q, kn, vn, tables, kv_len,
                                           k_new, v_new)

            b_ms, n_ms, t = abba(base_step, new_step, flush)
            if not (torch.equal(kb, kn) and torch.equal(vb, vn)):
                raise RuntimeError(f"paged {case}: the steps' pages differ")
            diff = float((o["base_step"].float()
                          - o["new_step"].float()).abs().max())
            if diff > tol:
                raise RuntimeError(f"paged {case} step: trees differ by "
                                   f"{diff}")
            row.update(base_step_ms=b_ms, new_step_ms=n_ms,
                       step_readings_ms=t, step_new_over_base=n_ms / b_ms,
                       step_max_abs_diff=diff)
        emit(row)

    for case, (B, Hq, KV, S, d, _) in flash_cases.items():
        q, k, v = (torch.randn(B, S, h, d, generator=g, device="cuda")
                   .bfloat16().transpose(1, 2) for h in (Hq, KV, KV))
        o_base, o_new = torch.empty_like(q), torch.empty_like(q)
        fb = lambda: flash_call(libs["flash_attention", "base"], q, k, v,  # noqa: E731
                                o_base)
        fn = lambda: flash_call(libs["flash_attention", "new"], q, k, v,  # noqa: E731
                                o_new)
        base_ms, new_ms, t = abba(fb, fn, flush)
        diff = float((o_base.float() - o_new.float()).abs().max())
        if diff > chip_smoke.TOL[torch.bfloat16]:
            raise RuntimeError(f"flash {case}: trees differ by {diff}")
        emit({"kernel": "flash_attention", "case": case, "B": B, "S": S,
              "base_ms": base_ms, "new_ms": new_ms, "readings_ms": t,
              "new_over_base": new_ms / base_ms, "max_abs_diff": diff})

    for case, (T, D, F, G, r, bt) in lora_cases.items():
        x, w, a, b = chip_smoke.lora_inputs(T, D, F, G, r, torch.bfloat16,
                                            seed=T + F)
        tiles = torch.zeros(-(-T // bt), dtype=torch.int32, device="cuda")
        work = torch.empty(-(-D // 128) * T * (F + r), device="cuda")
        o_base = torch.empty(T, F, dtype=torch.bfloat16, device="cuda")
        o_new = torch.empty_like(o_base)
        split = T <= lora_kernel.SPLIT_T
        fb = lambda: lora_call(libs["batched_lora", "base"], x, w, a, b,  # noqa: E731
                               tiles, o_base, work, split)
        fn = lambda: lora_call(libs["batched_lora", "new"], x, w, a, b,  # noqa: E731
                               tiles, o_new, work, split)
        base_ms, new_ms, t = abba(fb, fn, flush)
        diff = float((o_base.float() - o_new.float()).abs().max())
        if diff > chip_smoke.LORA_TOL[torch.bfloat16]:
            raise RuntimeError(f"LoRA {case}: trees differ by {diff}")
        emit({"kernel": "batched_lora", "case": case, "T": T, "F": F,
              "new_path": "split" if split else "tiled",
              "base_ms": base_ms, "new_ms": new_ms, "readings_ms": t,
              "new_over_base": new_ms / base_ms, "max_abs_diff": diff})

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    worst = max(rows, key=lambda r: r["new_over_base"])
    print(json.dumps({"worst": {k: worst[k] for k in
                                ("kernel", "case", "new_over_base")},
                      "card": smi}), flush=True)


if __name__ == "__main__":
    main()
