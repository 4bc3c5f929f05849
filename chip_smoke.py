#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits non-zero without printing a result:

1. environment: the card (``nvidia-smi``), torch and CUDA versions, and the
   build of the hand-written CUDA kernel from this checkout's sources;
2. kernels: the CUDA paged-attention kernel against its plain PyTorch
   version on the card, in bf16 (rtol/atol 2e-2) and fp32 (2e-5, TF32 off),
   at the demo, TinyLlama, main-path and long shapes, with its time beside
   the plain version's, an SDPA call's (a yardstick the port never calls)
   and the least time the card could take (the bound);
3. engine: the block zoo's three apps (base, vicuna FPFT, app-lora PEFT)
   served through ``BlockEngine.submit/drain`` at TinyLlama-1.1B width
   (22 layers, d_model 2048; random weights from seed 0), 12 requests; the
   kernel's launch count is set to 0 just before and read just after, and
   must equal the executor's paged-attention calls; then eight steady
   decode steps of the same traffic under ``torch.profiler`` for the
   device's busy share and the time by kernel;
4. parity on the card: the fused megastep against the per-hop path, token
   for token, and ``attn_impl="cuda"`` against ``attn_impl="ref"``, equal
   wherever the ref run's top-2 logit margin is clear.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits non-zero before printing anything.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import peft  # noqa: E402
from repro_torch.core.blocks import chain_prefill_fused  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref,
)
from repro_torch.serving.api import ServeRequest  # noqa: E402
from repro_torch.serving.demo import build_demo_zoo  # noqa: E402
from repro_torch.serving.engine import BlockEngine, EngineConfig  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; dense bf16 tensor-core
# FLOP/s; fp32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
CLEAR_MARGIN = 0.25  # top-2 logit gap (~16 bf16 ulps at |logit| 2-4)
MODEL = "tinyllama-1.1b"
MAX_LEN = 256
PAGE = 16
N_REQUESTS, GEN_LEN = 12, 32
APPS = ("base", "vicuna", "app-lora")
KERNEL_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
KERNEL_REPLACES = "src/repro/kernels/paged_attention/kernel.py:71"
DEVICE = "cuda"
SPIN_CYCLES = 2_000_000  # ~1 ms at H100 clocks: longer than any enqueue here
PROFILE_STEPS = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_inputs(B, Hq, KVH, hd, nps, seq_lens, num_pages, dtype, seed):
    """q, page slabs, shuffled disjoint page tables padded with trash page 0
    past each row's last page, and the int32 lengths, on the card."""
    g = torch.Generator(DEVICE).manual_seed(seed)
    dev = torch.device(DEVICE)
    q = torch.randn(B, Hq, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(num_pages, PAGE, KVH, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(num_pages, PAGE, KVH, hd, generator=g, device=dev).to(dtype)
    rng = np.random.RandomState(seed)
    pages = rng.permutation(num_pages - 1)[:B * nps] + 1
    tables = pages.reshape(B, nps).astype(np.int32)
    for b, n in enumerate(seq_lens):
        tables[b, -(-n // PAGE):] = 0
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.tensor(seq_lens, dtype=torch.int32, device=dev))


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of one call of ``fn``, with the L2 cache flushed
    before each call (the serving engine finds a layer's pages cold: 22
    layers' worth of KV and weights pass through the 50 MB L2 between two
    visits).  A spin kernel keeps the card busy while the host enqueues the
    start event, the call and the end event, so the events bracket device
    work only, not the Python wrapper's host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(q, seq_lens, KVH, dtype):
    """Least time for this call: bytes each input read once and the output
    written once (K/V only for the valid tokens, table entries only for the
    pages those tokens use) over HBM bandwidth, against 4*len*Hq*hd flops
    over the dtype's peak.  Returns (ms, "bytes" | "operations")."""
    B, Hq, hd = q.shape
    item = q.element_size()
    total = int(sum(seq_lens))
    nbytes = (2 * q.numel() * item                    # q in, out
              + 2 * total * KVH * hd * item            # K and V
              + 4 * sum(-(-n // PAGE) for n in seq_lens)  # table entries
              + 4 * B)                                 # seq_lens
    flops = 4.0 * total * Hq * hd
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_yardstick(q, k, v, tables, seq_lens):
    """One SDPA call on K/V gathered beforehand (GQA enabled, boolean mask):
    a library yardstick timed here only; the port never calls it."""
    B, Hq, hd = q.shape
    _, page, KVH, _ = k.shape
    n = tables.shape[1]
    kd = k[tables.long()].reshape(B, n * page, KVH, hd).transpose(1, 2)
    vd = v[tables.long()].reshape(B, n * page, KVH, hd).transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    pos = torch.arange(n * page, device=q.device)
    mask = (pos[None, :] < seq_lens[:, None])[:, None, None, :]
    qd = q[:, :, None, :]

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True)

    return call


def kernel_phase(cases, flush):
    rows = []
    for name, (B, Hq, KVH, hd, nps, seq_lens, num_pages) in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, tables, lens = kernel_inputs(
                B, Hq, KVH, hd, nps, seq_lens, num_pages, dtype, seed=len(rows))
            got = paged_attention(q, k, v, tables, lens, impl="cuda")
            torch.cuda.synchronize()
            want = paged_attention_ref(q, k, v, tables, lens)
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            iters = 50 if max(seq_lens) <= MAX_LEN else 20
            k_ms = time_ms(lambda: paged_attention(q, k, v, tables, lens,
                                                   impl="cuda"), iters, flush)
            r_ms = time_ms(lambda: paged_attention_ref(q, k, v, tables, lens),
                           iters, flush)
            lib = sdpa_yardstick(q, k, v, tables, lens)
            lib_err = float((lib()[:, :, 0].float() - want.float()).abs().max())
            l_ms = time_ms(lib, iters, flush)
            b_ms, b_by = bound(q, seq_lens, KVH, dtype)
            row = {"phase": "kernels", "case": name, "dtype": str(dtype),
                   "B": B, "Hq": Hq, "KVH": KVH, "hd": hd, "page": PAGE,
                   "pages_per_seq": nps, "num_pages": num_pages,
                   "seq_len_sum": int(sum(seq_lens)),
                   "seq_len_max": int(max(seq_lens)), "tol": tol,
                   "max_abs_err": err, "library_max_abs_err": lib_err,
                   "kernel_ms": k_ms, "ref_ms": r_ms, "library_ms": l_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 3: the engine at TinyLlama-1.1B width
# ---------------------------------------------------------------------------


def build_zoo():
    """The demo zoo at full width, with app-lora re-registered on LoRA
    adapters whose B matrices are nonzero (the recipe starts them at zero,
    which would make app-lora numerically the base model)."""
    cfg, _, zoo = build_demo_zoo(0, config=MODEL, device=DEVICE)
    lora = peft.create_lora(cfg, torch.Generator(DEVICE).manual_seed(2))
    g = torch.Generator(DEVICE).manual_seed(100)
    for layer in lora:
        layer["b_q"].normal_(0.0, 0.05, generator=g)
        layer["b_v"].normal_(0.0, 0.05, generator=g)
    zoo.register_peft("app-lora", cfg, "base", "lora", lora)
    torch.cuda.synchronize()
    return cfg, zoo


def traffic(cfg, n=N_REQUESTS, gen_len=GEN_LEN, seed=0):
    rng = np.random.RandomState(seed)
    return [ServeRequest(app=APPS[i % 3], gen_len=gen_len,
                         prompt_tokens=rng.randint(
                             0, cfg.vocab_size, size=int(rng.randint(16, 129))
                         ).astype(np.int32)) for i in range(n)]


def engine(zoo, **kw):
    return BlockEngine(zoo, max_len=MAX_LEN, config=EngineConfig(
        max_active=16, max_block_batch=16, page_size=PAGE, device=DEVICE,
        **kw))


def serve(eng, reqs, interleave=False):
    """Submit copies of ``reqs`` and drain; with ``interleave`` the second
    half joins one step after the first.  Returns results in request order."""
    reqs = [ServeRequest(app=r.app, gen_len=r.gen_len,
                         prompt_tokens=r.prompt_tokens) for r in reqs]
    half = len(reqs) // 2 if interleave else len(reqs)
    rids = [eng.submit(r) for r in reqs[:half]]
    done = {}
    if interleave:
        done.update({r.rid: r for r in eng.step()})
        rids += [eng.submit(r) for r in reqs[half:]]
    done.update({r.rid: r for r in eng.drain()})
    torch.cuda.synchronize()
    if sorted(done) != sorted(rids):
        raise RuntimeError(f"requests lost: {sorted(set(rids) - set(done))}")
    return [done[r] for r in rids]


def engine_phase(cfg, zoo, smi):
    reqs = traffic(cfg)
    # warm-up on a separate engine: cuBLAS handles, the per-block bf16
    # weight copies, the allocator's pools
    serve(engine(zoo), traffic(cfg, n=3, gen_len=4, seed=1))
    eng = engine(zoo)
    torch.cuda.reset_peak_memory_stats()
    pa_kernel.launches = 0
    t0 = time.perf_counter()
    results = serve(eng, reqs)
    wall = time.perf_counter() - t0
    launches = pa_kernel.launches
    stats = dict(eng.stats)
    for r in results:
        if len(r.tokens) != GEN_LEN or r.tokens.min() < 0 \
                or r.tokens.max() >= cfg.vocab_size:
            raise RuntimeError(f"rid {r.rid}: bad tokens {r.tokens}")
        if r.probs_last is None or not np.isfinite(r.probs_last).all() \
                or abs(float(r.probs_last.sum()) - 1.0) > 1e-3:
            raise RuntimeError(f"rid {r.rid}: bad final distribution")
    if stats["attn_calls"] <= 0 or launches != stats["attn_calls"]:
        raise RuntimeError(f"paged_attention launches {launches} != "
                           f"executor attention calls {stats['attn_calls']}")
    snap = eng.metrics.snapshot()["histograms"]
    tokens = sum(len(r.tokens) for r in results)
    row = {"phase": "engine", "model": MODEL, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "requests": len(results),
           "apps": sorted({r.app for r in results}), "gen_len": GEN_LEN,
           "prompt_lens": [int(r.prompt_tokens.shape[0]) for r in reqs],
           "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
           "step_wall_p50_s": snap["step_wall_s"]["p50"],
           "step_wall_p95_s": snap["step_wall_s"]["p95"],
           "ttft_p50_s": snap["ttft_s"]["p50"],
           "group_calls_per_token": stats["group_calls"]
           / max(stats["decode_tokens"], 1),
           "host_syncs": stats["host_syncs"], "steps": stats["steps"],
           "paged_attention_launches": launches,
           "attn_calls": stats["attn_calls"],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "card": smi}
    emit(row)
    return reqs, results, launches, row


def profile_phase(zoo, reqs, step_wall_p50):
    """Where the engine's time goes in steady decode: the same traffic on a
    fresh engine, ``PROFILE_STEPS`` engine steps after admission and
    prefill recorded with ``torch.profiler`` (kernels only).  The device's
    busy share is the device time per step over the measured (unprofiled)
    run's median step wall; the profiler's own host cost slows the
    profiled steps, not the device work they record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = engine(zoo)
    for r in reqs:
        eng.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                prompt_tokens=r.prompt_tokens))
    for _ in range(4):  # admission + prefill, then the decode groups form
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
    eng.drain()
    by_kernel = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA), reverse=True)
    device_s = sum(us for us, _, _ in by_kernel) / 1e6 / PROFILE_STEPS
    pa_s = sum(us for us, _, k in by_kernel
               if "paged_attention" in k) / 1e6 / PROFILE_STEPS
    gemm_s = sum(us for us, _, k in by_kernel
                 if "nvjet" in k or "gemm" in k.lower()) / 1e6 / PROFILE_STEPS
    row = {"phase": "profile", "steps": PROFILE_STEPS,
           "device_s_per_step": device_s, "step_wall_p50_s": step_wall_p50,
           "device_busy_share": device_s / step_wall_p50,
           "paged_attention_s_per_step": pa_s,
           "paged_attention_share_of_device": pa_s / max(device_s, 1e-12),
           "gemm_share_of_device": gemm_s / max(device_s, 1e-12),
           "kernel_launches_per_step": sum(n for _, n, _ in by_kernel)
           / PROFILE_STEPS,
           "top": [{"kernel": k[:80], "device_ms_per_step":
                    us / 1e3 / PROFILE_STEPS, "calls_per_step":
                    n / PROFILE_STEPS} for us, n, k in by_kernel[:8]]}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 4: parity on the card
# ---------------------------------------------------------------------------


def fused_vs_per_hop(cfg, zoo):
    """A single-app group (two app-lora requests, the second joining one
    step later so each prefill runs at the same shape on both paths):
    fused megastep and per-hop dispatch must give identical tokens."""
    rng = np.random.RandomState(7)
    reqs = [ServeRequest(app="app-lora", gen_len=12,
                         prompt_tokens=rng.randint(0, cfg.vocab_size, size=n)
                         .astype(np.int32)) for n in (32, 64)]
    fused = serve(engine(zoo), reqs, interleave=True)
    hop = serve(engine(zoo, fused=False), reqs, interleave=True)
    for f, h in zip(fused, hop):
        if not np.array_equal(f.tokens, h.tokens):
            raise RuntimeError(f"fused {f.tokens} != per-hop {h.tokens}")
    out = {"phase": "parity_fused_vs_per_hop", "app": "app-lora",
           "requests": len(reqs), "tokens_each": 12, "identical": True}
    emit(out)
    return out


def ref_margin(zoo, app, prefix):
    """Top-2 logit gap of the ref path's next token after ``prefix``
    (a prefill replay; log-probabilities differ from logits by a constant)."""
    chain = zoo.chains[app]
    steps = [(zoo.blocks[s.block_id],
              tuple(zoo.blocks[a] for a in s.adapter_ids))
             for s in chain.steps]
    tok = torch.as_tensor(prefix[None], dtype=torch.int32, device=DEVICE)
    lens = torch.tensor([len(prefix)], dtype=torch.int32, device=DEVICE)
    _, probs, _ = chain_prefill_fused(steps, tok, lens)
    top2 = torch.log(probs[0]).topk(2).values
    return float(top2[0] - top2[1])


def cuda_vs_ref(zoo, reqs, cuda_results):
    ref = serve(engine(zoo, attn_impl="ref"), reqs)
    agree = compared = identical = 0
    divergences = []
    for req, c, r in zip(reqs, cuda_results, ref):
        diff = np.nonzero(c.tokens != r.tokens)[0]
        if not len(diff):
            identical += 1
            agree += len(c.tokens)
            compared += len(c.tokens)
            continue
        j = int(diff[0])
        agree += j
        compared += j + 1
        prefix = np.concatenate([req.prompt_tokens, r.tokens[:j]])
        divergences.append({"app": req.app, "at": j,
                            "ref_margin": ref_margin(zoo, req.app, prefix)})
    out = {"phase": "parity_cuda_vs_ref", "requests": len(reqs),
           "identical_streams": identical, "tokens_compared": compared,
           "tokens_agree": agree, "agreement": agree / max(compared, 1),
           "clear_margin": CLEAR_MARGIN, "divergences": divergences}
    emit(out)
    clear = [d for d in divergences if d["ref_margin"] > CLEAR_MARGIN]
    if clear:
        raise RuntimeError(f"cuda and ref disagree at a clear margin: {clear}")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on an NVIDIA GPU")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    pa_kernel.load()
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "card": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "kernel_library": str(pa_kernel.library_path().relative_to(ROOT))})

    cfg = get_config(MODEL)
    G_kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    nps = MAX_LEN // PAGE
    engine_pages = 1 + 16 * nps * cfg.num_layers
    rng = np.random.RandomState(0)
    ragged = [1, 16, 17, MAX_LEN]
    main_lens = [int(r.prompt_tokens.shape[0]) + GEN_LEN // 2
                 for r in traffic(cfg)[:4]]

    def lens(edge, n, hi):
        return edge + [int(x) for x in rng.randint(1, hi + 1, n)]

    cases = {  # B, Hq, KVH, hd, pages per seq, seq_lens, pool pages
        "demo": (8, 8, 4, 32, nps, lens(ragged, 4, MAX_LEN), 1 + 8 * nps),
        "tinyllama": (16, cfg.num_heads, G_kv, hd, nps,
                      lens(ragged, 12, MAX_LEN), 1 + 16 * nps),
        "main_path": (4, cfg.num_heads, G_kv, hd, nps, main_lens,
                      engine_pages),
        "long": (16, cfg.num_heads, G_kv, hd, 4096 // PAGE,
                 lens([1, 16, 17, 4096], 12, 4096), 1 + 16 * 4096 // PAGE),
    }
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    t0 = time.perf_counter()
    rows = kernel_phase(cases, flush)
    del flush
    phase_s = {"kernels": time.perf_counter() - t0}

    t0 = time.perf_counter()
    cfg, zoo = build_zoo()
    zoo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    emit({"phase": "zoo", "model": MODEL, "build_s": zoo_s,
          "blocks": len(zoo.blocks), "zoo_bytes": zoo.zoo_bytes(),
          "equivalences": len(zoo.equivalences) // 2})
    reqs, results, launches, eng_row = engine_phase(cfg, zoo, smi)
    phase_s["engine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profile_phase(zoo, reqs, eng_row["step_wall_p50_s"])
    phase_s["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused_vs_per_hop(cfg, zoo)
    cuda_vs_ref(zoo, reqs, results)
    phase_s["parity"] = time.perf_counter() - t0

    main = next(r for r in rows if r["case"] == "main_path"
                and r["dtype"] == "torch.bfloat16")
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["case"] == "main_path"),
        "ms": main["kernel_ms"], "plain_ms": main["ref_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"]}]})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start,
          "kernel_build_s": build_s, "zoo_build_s": zoo_s,
          "phase_s": phase_s, "tok_per_s": eng_row["tok_per_s"]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
