"""End-to-end driver: serve a small multi-tenant model zoo through the
unified Server API — continuous-batching real execution on the port
(shared paged KV pool, cross-app batching, optional §5.2 draft-verify
speculation), adaptive serving (paper Fig. 20), plus the cluster-scale
discrete-event evaluation of the same scheduler on the paper's 12-device
cluster, its times modeled from H100 constants.  The port of
``examples/serve_multitenant.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_multitenant
    PYTHONPATH=src python -m repro_torch.examples.serve_multitenant --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_multitenant --no-speculation

Scheduler/speculation flags come straight from ``SchedulerConfig.add_args``
(one source of truth with the simulator and the launcher); ``--device``
says where the engine runs (the card unless the caller asks for the CPU).
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.serving.api import ServeRequest
from repro_torch.serving.demo import build_demo_zoo
from repro_torch.serving.engine import (
    BlockEngine,
    EngineConfig,
    adaptive_serving_similarity,
)
from repro_torch.serving.request import as_serve_requests, generate_trace
from repro_torch.serving.simulator import (
    SchedulerConfig,
    Simulation,
    build_serving_config,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    SchedulerConfig.add_args(ap)
    args = ap.parse_args(argv)
    sched = SchedulerConfig.from_args(args)

    # ---- real execution: continuous batching across three tenants ----
    cfg, _, zoo = build_demo_zoo(seed=0, device=args.device)
    engine = BlockEngine(zoo, max_len=64, config=EngineConfig(
        policy=sched.policy,
        speculation=sched.speculation,
        spec_lookahead=sched.spec_lookahead,
        spec_prune_ratio=sched.spec_prune_ratio,
        spec_min_accept=sched.spec_min_accept,
        device=args.device))
    rng = np.random.RandomState(7)
    apps = ("base", "vicuna", "app-lora")
    for i in range(12):  # 12 in-flight requests, mixed apps
        prompt = rng.randint(0, cfg.vocab_size, size=24).astype(np.int32)
        engine.submit(ServeRequest(app=apps[i % 3], gen_len=8,
                                   prompt_tokens=prompt))
    t0 = time.perf_counter()
    results = engine.drain()
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in results)
    print(f"continuous batching: {len(results)} reqs x 3 apps -> {toks} "
          f"tokens in {dt:.2f}s ({toks / dt:.1f} tok/s on {args.device}, "
          f"{engine.stats['group_calls']} batched block calls)")
    if sched.speculation:
        print(f"speculation       : {engine.stats['spec_hits']}/"
              f"{engine.stats['spec_attempts']} drafts accepted "
              f"(rate {engine.metrics.gauge('spec_accept_rate').value:.2f},"
              f" lookahead {sched.spec_lookahead})")
    for r in sorted(results, key=lambda r: r.rid)[:3]:
        print(f"  [{r.app:8s}] rid={r.rid} sample={r.tokens[:6].tolist()}")

    prompts = np.random.RandomState(7).randint(
        0, cfg.vocab_size, size=(4, 24)).astype(np.int32)
    sim, n = adaptive_serving_similarity(zoo, engine, "vicuna", prompts,
                                         gen_len=6)
    print(f"adaptive serving  : {n} block(s) swapped, output prob cosine "
          f"{sim:.3f} (paper Fig. 20: 0.88)")

    # ---- cluster-scale evaluation: paper §7.1 setup, modeled time ----
    print("\n12-device cluster, 20 apps, 400 requests (paper §7.1; times "
          "modeled from H100 constants):")
    for mode in ("blockllm", "pm", "ps"):
        scfg = build_serving_config(n_foundations=3, n_apps=20, mode=mode)
        trace = generate_trace(list(scfg.chains), total_requests=400,
                               duration_s=600, seed=0,
                               prompt_len=(64, 512), gen_len=(64, 256))
        server = Simulation(scfg, dataclasses.replace(sched, mode=mode))
        for req in as_serve_requests(trace):
            server.submit(req)
        server.drain()
        m = server.metrics()
        print(f"  {mode:9s} median={m['median_latency']:6.1f}s "
              f"p95={m['p95_latency']:6.1f}s "
              f"thpt={m['throughput_tokens_s']:6.1f} tok/s "
              f"util={m['gpu_utilization'] * 100:4.1f}%")


if __name__ == "__main__":
    main()
