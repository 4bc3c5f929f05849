"""The port's discrete-event simulator, cluster model and cost model
(numpy only) against the JAX package's: with the port's H100 constants
swapped for the reference's TPU v5e ones, ``Simulation.metrics()`` is
exactly JAX's in all three modes; at the H100 constants a run completes
every request.  Also the reference's run-equals-submit/drain check and
the engine/simulator speculation stat names (``tests/test_spec_decode.py``
``test_spec_stat_keys_aligned``) on the port."""
import dataclasses

import pytest

from repro_torch.serving import cluster, cost_model, request, simulator
from repro_torch.serving.request import as_serve_requests, generate_trace
from repro_torch.serving.simulator import (
    SchedulerConfig,
    Simulation,
    build_serving_config,
)

CONSTANTS = ("PEAK_FLOPS", "HBM_BW", "INTRA_SERVER_BW", "INTER_SERVER_BW",
             "HOST_TO_DEVICE_BW", "DEVICE_MEMORY")
MODES = ("blockllm", "pm", "ps")


def use_v5e_constants(monkeypatch) -> None:
    """Give the port's cluster, cost model and simulator the reference's
    TPU v5e constants, devices included."""
    from repro.serving import cluster as jax_cluster

    for mod in (cluster, cost_model, simulator):
        for name in CONSTANTS:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, getattr(jax_cluster, name))
    paper = cluster.paper_cluster

    def v5e_cluster():
        c = paper()
        for d in c.devices:
            d.memory = jax_cluster.DEVICE_MEMORY
        return c

    monkeypatch.setattr(simulator, "paper_cluster", v5e_cluster)


def _trace(cfg, mod):
    return mod.generate_trace(list(cfg.chains), total_requests=60,
                              duration_s=60, seed=5)


@pytest.mark.parametrize("mode", MODES)
def test_metrics_equal_jax_under_v5e_constants(monkeypatch, mode):
    from repro.serving import request as jax_request
    from repro.serving import simulator as jax_sim

    use_v5e_constants(monkeypatch)
    jcfg = jax_sim.build_serving_config(n_apps=4, mode=mode)
    want = jax_sim.Simulation(
        jcfg, jax_sim.SchedulerConfig(mode=mode)).run(
            _trace(jcfg, jax_request))
    cfg = build_serving_config(n_apps=4, mode=mode)
    trace = _trace(cfg, request)
    assert [dataclasses.astuple(r) for r in trace] == \
        [dataclasses.astuple(r) for r in _trace(jcfg, jax_request)]
    got = Simulation(cfg, SchedulerConfig(mode=mode)).run(trace)
    assert got == want
    assert got["completed"] == 60


def test_h100_constants_complete_every_request():
    """At the port's own constants (NVIDIA H100 SXM: 989e12 bf16 FLOP/s,
    3.35e12 B/s, NVLink 450e9, the paper's 12.5e9 network, PCIe 64e9,
    80e9 bytes a device) every mode completes the whole trace."""
    assert (cluster.PEAK_FLOPS, cluster.HBM_BW, cluster.INTRA_SERVER_BW,
            cluster.INTER_SERVER_BW, cluster.HOST_TO_DEVICE_BW,
            cluster.DEVICE_MEMORY) == (989e12, 3.35e12, 450e9, 12.5e9, 64e9,
                                       80e9)
    assert cost_model.PEAK_FLOPS == simulator.PEAK_FLOPS == cluster.PEAK_FLOPS
    assert all(d.memory == 80e9 for d in cluster.paper_cluster().devices)
    for mode in MODES:
        cfg = build_serving_config(n_apps=6, mode=mode)
        m = Simulation(cfg, SchedulerConfig(mode=mode)).run(
            generate_trace(list(cfg.chains), total_requests=60,
                           duration_s=60, seed=5))
        assert m["completed"] == 60, mode
        assert m["median_latency"] > 0 and m["throughput_tokens_s"] > 0


def test_simulator_run_equals_submit_drain():
    cfg = build_serving_config(n_foundations=2, n_apps=6)
    trace = generate_trace(list(cfg.chains), total_requests=60,
                           duration_s=60, seed=5)
    a = Simulation(cfg, SchedulerConfig())
    m_run = a.run(trace)

    b = Simulation(cfg, SchedulerConfig())
    for req in as_serve_requests(trace):
        b.submit(req)
    results = b.drain()
    m_api = b.metrics()
    assert len(results) == m_run["completed"]
    assert m_api["median_latency"] == pytest.approx(m_run["median_latency"])
    assert m_api["throughput_tokens_s"] == pytest.approx(
        m_run["throughput_tokens_s"])


def test_spec_stat_keys_aligned():
    """Both backends expose the same speculation stat names in the same
    places: ``spec_attempts``/``spec_hits`` counters (pre-registered, so
    they appear even before speculation runs) and a ``spec_accept_rate``
    gauge, plus ``spec_accept_rate`` in the simulator's report dict."""
    from repro_torch.serving.demo import build_demo_zoo
    from repro_torch.serving.engine import BlockEngine, EngineConfig

    _, _, zoo = build_demo_zoo(0, device="cpu")
    engine = BlockEngine(zoo, max_len=64, config=EngineConfig(
        device="cpu", speculation=True))
    sim = Simulation(build_serving_config(n_foundations=1, n_apps=2),
                     SchedulerConfig())
    for name in ("spec_attempts", "spec_hits"):
        assert name in engine.stats
        assert name in dict(sim.metrics_registry.counters_view())
    for m in (engine.metrics, sim.metrics_registry):
        assert m.gauge("spec_accept_rate").value == 0.0
    sim.submit(simulator.ServeRequest(app="app0", gen_len=4, prompt_len=16))
    sim.drain()
    assert "spec_accept_rate" in sim.metrics()
    # the shared auto-CLI dataclass carries the engine-side knobs too
    for field in ("spec_lookahead", "spec_prune_ratio", "spec_min_accept"):
        assert hasattr(SchedulerConfig(), field)
        assert getattr(SchedulerConfig(), field) == \
            getattr(EngineConfig(), field)
