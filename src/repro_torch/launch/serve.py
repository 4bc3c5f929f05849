"""Serving launcher over the unified Server API (DESIGN.md §2) — the port
of ``repro.launch.serve``.

Two backends, one interface (submit / step / drain):

    # paper §7 evaluation on the modeled 12-device cluster (numpy only;
    # times modeled from the H100 constants of repro_torch.serving.cluster)
    PYTHONPATH=src python -m repro_torch.launch.serve --backend sim --apps 20

    # real execution on the card: continuous batching over the demo zoo at
    # TinyLlama-1.1B width through the port's CUDA kernels
    PYTHONPATH=src python -m repro_torch.launch.serve --backend real \\
        --config tinyllama-1.1b --requests 12

    # the same on the CPU at the demo width (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.serve --backend real \\
        --device cpu --requests 8

Scheduler flags are generated straight from ``SchedulerConfig`` fields
(``SchedulerConfig.add_args`` — one source of truth, no hand-copied
argparse declarations); the real backend also takes ``--device`` and
``--config``, the model configuration of the demo zoo.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.observability import percentiles_of
from repro_torch.serving.api import ServeRequest
from repro_torch.serving.demo import build_demo_zoo
from repro_torch.serving.engine import BlockEngine, EngineConfig
from repro_torch.serving.request import as_serve_requests, generate_trace
from repro_torch.serving.simulator import (
    SchedulerConfig,
    Simulation,
    build_serving_config,
)


def run_sim(args) -> dict:
    cfg = build_serving_config(n_foundations=3, n_apps=args.apps,
                               mode=args.mode)
    trace = generate_trace(list(cfg.chains), total_requests=args.requests,
                           duration_s=args.duration, seed=0,
                           prompt_len=(64, 512), gen_len=(64, 256))
    server = Simulation(cfg, SchedulerConfig.from_args(args))
    for req in as_serve_requests(trace):
        server.submit(req)
    results = server.drain()
    metrics = server.metrics()
    metrics["completed_via_api"] = len(results)
    if getattr(args, "trace_out", None):
        server.tracer.write_chrome_trace(args.trace_out)
    if getattr(args, "metrics_out", None):
        server.metrics_registry.write(args.metrics_out)
    return metrics


def run_real(args) -> dict:
    cfg, _, zoo = build_demo_zoo(seed=0, config=args.config,
                                 device=args.device)
    # engine-side §5.2 speculation rides the shared SchedulerConfig flags:
    # --speculation/--no-speculation, --spec-lookahead, --spec-prune-ratio,
    # --spec-min-accept toggle the real draft-verify decode path here
    engine = BlockEngine(zoo, max_len=args.max_len,
                         config=EngineConfig(
                             max_active=args.max_batch,
                             policy=args.policy,
                             speculation=args.speculation,
                             spec_lookahead=args.spec_lookahead,
                             spec_prune_ratio=args.spec_prune_ratio,
                             spec_min_accept=args.spec_min_accept,
                             device=args.device))
    apps = list(zoo.chains)
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = rng.randint(0, cfg.vocab_size,
                             size=int(rng.randint(8, 24))).astype(np.int32)
        engine.submit(ServeRequest(app=apps[i % len(apps)],
                                   gen_len=args.gen_len,
                                   prompt_tokens=prompt))
    results = engine.drain()
    dt = time.perf_counter() - t0
    gen_tokens = sum(len(r.tokens) for r in results)
    lats = sorted(r.info["latency_s"] for r in results
                  if r.info and "latency_s" in r.info)
    pct = (lambda q: round(lats[min(len(lats) - 1,
                                    int(q * (len(lats) - 1) + 0.5))], 4)
           ) if lats else (lambda q: 0.0)
    ttft = percentiles_of([r.info["ttft_s"] for r in results
                           if r.info and "ttft_s" in r.info])
    qwait = percentiles_of([r.info["queue_wait_s"] for r in results
                            if r.info and "queue_wait_s" in r.info])
    if getattr(args, "trace_out", None):
        engine.write_trace(args.trace_out)
    if getattr(args, "metrics_out", None):
        engine.write_metrics(args.metrics_out)
    stats = dict(engine.stats)
    return {
        "completed": len(results),
        "generated_tokens": gen_tokens,
        "wall_s": round(dt, 3),
        "tokens_per_s": round(gen_tokens / max(dt, 1e-9), 2),
        "spec_attempts": stats.get("spec_attempts", 0),
        "spec_hits": stats.get("spec_hits", 0),
        "spec_accept_rate": round(
            engine.metrics.gauge("spec_accept_rate").value, 4),
        "latency_p50_s": pct(0.50),
        "latency_p95_s": pct(0.95),
        "ttft_p50_s": round(ttft[50], 4),
        "ttft_p95_s": round(ttft[95], 4),
        "queue_wait_p50_s": round(qwait[50], 4),
        "queue_wait_p95_s": round(qwait[95], 4),
        "engine_stats": stats,
        "sample": results[0].tokens[:8].tolist() if results else [],
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="sim", choices=["sim", "real"])
    # workload knobs
    ap.add_argument("--apps", type=int, default=20)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    # the real backend's device and the demo zoo's model configuration
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="blockllm-demo")
    # observability artifacts (DESIGN.md §8), both backends
    ap.add_argument("--trace-out", default=None,
                    help="write Chrome trace_event JSON of the run; its "
                    "clock anchors (otherData) line it up with a "
                    "torch.profiler trace of the same process")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry snapshot JSON")
    # scheduler knobs: generated from the dataclass, shared with the sim
    SchedulerConfig.add_args(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    metrics = run_sim(args) if args.backend == "sim" else run_real(args)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in metrics.items()}, indent=1))


if __name__ == "__main__":
    main()
