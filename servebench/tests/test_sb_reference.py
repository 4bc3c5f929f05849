"""The frozen float32 reference against the port on the CPU, at the demo
zoo's width: the program's chains (base, FPFT, LoRA) give the reference's
logits, and the engine, served through the whole harness in float32,
serves the reference's argmax at every position."""
import torch

from repro_torch.core.blocks import run_chain
from servebench.drivers import engine as drv
from servebench.reference import dense
from servebench.tests import _tiny


def test_reference_matches_the_port_chains():
    cfg = _tiny.config(_tiny.DEMO, dtype="float32")
    w = drv.make_weights(cfg, 7, "cpu")
    zoo = drv.register(cfg, w, "cpu")
    d = drv.dims(cfg)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, d["V"], (40,), generator=g)
    for app in ("base", "vicuna", "app-lora"):
        got = run_chain(zoo, zoo.chains[app], toks[None],
                        compute_dtype=torch.float32)[0]
        want = dense.logits(w, d, [(app, toks, 0)])[0]
        assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), app
    # the apps differ: the FPFT layer and the LoRA deltas are in play
    base = dense.logits(w, d, [("base", toks, 0)])[0]
    for app in ("vicuna", "app-lora"):
        other = dense.logits(w, d, [(app, toks, 0)])[0]
        assert (other - base).abs().max() > 1e-2


def test_engine_in_float32_serves_the_reference_argmax():
    out = _tiny.run(cfg=_tiny.config(_tiny.DEMO, dtype="float32"),
                    mix=_tiny.mix())
    assert out["correct"]
    assert out["sample"]["positions"] >= 60
    assert out["checks"]["widest_gap"]["value"] < 1e-4


def test_closed_loop_serves_each_client_in_turn():
    mix = _tiny.mix()
    mix.update(loop="closed", clients=3, requests=12, preroll_inflight=0,
               preroll_s=0.2)
    out = _tiny.run(cfg=_tiny.config(_tiny.DEMO, dtype="float32"), mix=mix,
                    seconds=3.0)
    assert out["correct"]
    assert out["checks"]["widest_gap"]["value"] < 1e-4
