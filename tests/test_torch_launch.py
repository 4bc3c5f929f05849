"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the JAX package's: the scheduler flags generated from
``SchedulerConfig`` round-trip every field; ``--backend sim`` prints JAX's
JSON exactly once the port's H100 constants are swapped for the
reference's TPU v5e ones; ``--backend real --device cpu`` at the demo
width completes its requests (speculation on, the default), and in fp32
on the same weights gives the JAX launcher's sample tokens (the JAX
launcher runs in an fp32 subprocess, speculation off: its speculative
tokens are its plain ones, held against the port's in
``tests/test_torch_speculation.py``, and tracing them would double the
subprocess's time)."""
import argparse
import dataclasses
import functools
import json
import sys

import pytest
import torch

from repro_torch.launch import serve
from repro_torch.serving.simulator import SchedulerConfig

SIM_ARGS = ["--backend", "sim", "--apps", "6", "--requests", "60",
            "--duration", "60"]
REAL_ARGS = ["--backend", "real", "--requests", "4", "--gen-len", "6"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small CPU ops: under the
    suite's parallel workers the default threads oversubscribe the cores
    (as in tests/test_torch_engine.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _printed_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out)


def test_scheduler_config_arg_roundtrip():
    ap = argparse.ArgumentParser()
    SchedulerConfig.add_args(ap)
    # defaults roundtrip
    assert SchedulerConfig.from_args(ap.parse_args([])) == SchedulerConfig()
    # every field reachable from the CLI, each set away from its default
    argv, want = [], {}
    for f in dataclasses.fields(SchedulerConfig):
        flag = f.name.replace("_", "-")
        if isinstance(f.default, bool):
            argv.append(f"--no-{flag}" if f.default else f"--{flag}")
            want[f.name] = not f.default
        elif f.name in SchedulerConfig._ARG_CHOICES:
            value = SchedulerConfig._ARG_CHOICES[f.name][-1]
            argv += [f"--{flag}", value]
            want[f.name] = value
        else:
            value = f.default * 2 + 1
            argv += [f"--{flag}", str(value)]
            want[f.name] = type(f.default)(value)
    got = SchedulerConfig.from_args(ap.parse_args(argv))
    assert got == SchedulerConfig(**want)
    assert all(getattr(got, k) != getattr(SchedulerConfig(), k) for k in want)
    # bad choices rejected by the generated parser
    with pytest.raises(SystemExit):
        ap.parse_args(["--mode", "bogus"])
    # no hand-declared flag drift: one flag per dataclass field
    flags = {a.dest for a in ap._actions if a.dest != "help"}
    assert flags == {f.name for f in dataclasses.fields(SchedulerConfig)}


def test_launcher_flags():
    """The launcher's own flags beside the generated ones: the real
    backend runs on the card unless the caller asks for the CPU, on the
    demo configuration unless another is named."""
    args = serve.build_parser().parse_args([])
    assert (args.backend, args.device, args.config) == ("sim", "cuda",
                                                        "blockllm-demo")
    assert SchedulerConfig.from_args(args) == SchedulerConfig()


def test_sim_backend_prints_jax_json_under_v5e_constants(monkeypatch,
                                                         capsys):
    from test_torch_simulator import use_v5e_constants

    from repro.launch import serve as jax_serve

    monkeypatch.setattr(sys, "argv", ["serve"] + SIM_ARGS)
    jax_serve.main()
    want = _printed_json(capsys)
    use_v5e_constants(monkeypatch)
    serve.main(SIM_ARGS)
    got = _printed_json(capsys)
    assert got == want
    assert got["completed"] == got["completed_via_api"] == 60


_JAX_REAL = """
import contextlib, io, json, sys
from test_torch_blocks import jax_zoo
from repro.configs import get_config
from repro.launch import serve
from repro.serving import demo

demo.build_demo_zoo = lambda seed=0: (get_config("blockllm-demo"), TREES[0],
                                      jax_zoo(*TREES))
sys.argv = ["serve"] + {argv!r}
out = io.StringIO()
with contextlib.redirect_stdout(out):
    serve.main()
print(json.dumps(json.loads(out.getvalue())))
"""


def test_real_backend_cpu_matches_jax_launcher_fp32(monkeypatch, capsys):
    from test_torch_blocks import jax_demo_trees, jax_fp32_json, port_zoo

    from repro_torch.configs import get_config

    argv = REAL_ARGS + ["--no-speculation"]
    trees = jax_demo_trees()
    want = jax_fp32_json(_JAX_REAL.format(argv=argv), trees)
    monkeypatch.setattr(serve, "build_demo_zoo",
                        lambda seed, config, device: (
                            get_config(config), trees[0], port_zoo(*trees)))
    monkeypatch.setattr(serve, "EngineConfig", functools.partial(
        serve.EngineConfig, compute_dtype="float32"))
    serve.main(argv + ["--device", "cpu"])
    got = _printed_json(capsys)
    assert got["completed"] == want["completed"] == 4
    assert got["generated_tokens"] == want["generated_tokens"] == 4 * 6
    assert got["sample"] == want["sample"] and len(got["sample"]) == 6
    assert got["spec_attempts"] == want["spec_attempts"] == 0


def test_real_backend_cpu_demo_zoo(capsys):
    """The launcher as a user calls it on the CPU: the port's own demo zoo
    (bf16), speculation on (the default), every request completed."""
    serve.main(REAL_ARGS + ["--device", "cpu", "--policy", "priority"])
    got = _printed_json(capsys)
    assert got["completed"] == 4 and got["generated_tokens"] == 24
    assert got["spec_attempts"] > 0
    stats = got["engine_stats"]
    assert stats["completed"] == 4 and stats["attn_calls"] > 0
    assert got["ttft_p95_s"] >= got["ttft_p50_s"] > 0
