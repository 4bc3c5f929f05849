"""The port's numpy copy of JAX's threefry draws (``repro_torch.core.prng``)
against ``jax.random`` itself: keys exactly equal, normal draws within one
float32 ulp (measured: bitwise), and the two places the port uses them —
the speculation gate's fidelity probe (each demo signature's probe
fidelity in fp32 within 1e-5 of the JAX engine's) and
``recover_with_lora``'s default initial ``A`` (within one float32 ulp of
the reference's draw)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

APPS = ("base", "vicuna", "app-lora")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small CPU ops: under the
    suite's parallel workers the default threads oversubscribe the cores
    (as in tests/test_torch_engine.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    from test_torch_blocks import jax_demo_trees

    return jax_demo_trees()


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_keys_and_splits_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.key_data(key)))
    for num in (2, 3):
        np.testing.assert_array_equal(
            prng.split(prng.PRNGKey(seed), num),
            np.asarray(jax.random.split(key, num)))


@pytest.mark.parametrize("shape", [(1, 8, 256), (1, 8, 2048), (3, 1000)])
def test_bits_equal_jax(shape):
    np.testing.assert_array_equal(
        prng.random_bits(prng.PRNGKey(5), shape),
        np.asarray(jax.random.bits(jax.random.PRNGKey(5), shape, jnp.uint32)))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("d", [256, 2048])  # demo and TinyLlama-1.1B widths
def test_normal_within_one_ulp_of_jax(d, seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 8, d),
                                        jnp.float32))
    got = prng.normal(prng.PRNGKey(seed), (1, 8, d))
    assert got.dtype == np.float32 and got.shape == (1, 8, d)
    assert _ulps(got, want) <= 1


def test_recover_with_lora_default_a_is_the_reference_draw(trees):
    """With neither ``generator`` nor ``a_init`` given, recovery starts
    from the reference's ``0.01 * normal(split(PRNGKey(0))[0])``: zero
    steps leave that ``A`` as the result's ``recover_a``."""
    from test_torch_blocks import port_zoo

    from repro_torch.core.surrogates import build_surrogate, recover_with_lora

    zoo = port_zoo(*trees)
    blk = zoo.blocks[zoo.chains["base"].steps[1].block_id]
    probe = torch.zeros(1, 4, blk.d_in)
    rec = recover_with_lora(blk, build_surrogate(blk, 0.5), probe, steps=0)
    k1, _ = jax.random.split(jax.random.PRNGKey(0))
    want = np.asarray(0.01 * jax.random.normal(k1, (blk.d_in, 8),
                                               jnp.float32))
    got = rec.params["recover_a"].numpy()
    assert got.shape == want.shape
    assert _ulps(got, want) <= 1


_JAX_FIDELITIES = """
import json
from test_torch_blocks import jax_zoo
from repro.core.blocks import chain_signature
from repro.serving.engine import BlockEngine, EngineConfig

engine = BlockEngine(jax_zoo(*TREES), max_len=64,
                     config=EngineConfig(speculation=True))
out = {}
for app in ("base", "vicuna", "app-lora"):
    steps, _ = engine._steps(engine.zoo.chains[app], None)
    ss = engine._spec_state(chain_signature(steps), steps)
    out[app] = [float(ss.fidelity), bool(ss.enabled)]
print(json.dumps(out))
"""


def test_probe_fidelities_match_jax_engine_fp32(trees):
    """Each demo signature's probe fidelity (the worst over its pruned
    hops, at the default prune ratio) in fp32 within 1e-5 of the JAX
    engine's, and the gate decides alike."""
    from test_torch_blocks import jax_fp32_json, port_zoo

    from repro_torch.core.blocks import chain_signature
    from repro_torch.serving.engine import BlockEngine, EngineConfig

    want = jax_fp32_json(_JAX_FIDELITIES, trees)
    engine = BlockEngine(port_zoo(*trees), max_len=64,
                         config=EngineConfig(device="cpu",
                                             compute_dtype="float32",
                                             speculation=True))
    for app in APPS:
        steps, _ = engine._steps(engine.zoo.chains[app], None)
        ss = engine._spec_state(chain_signature(steps), steps)
        assert abs(ss.fidelity - want[app][0]) <= 1e-5, (app, ss.fidelity,
                                                         want[app])
        assert ss.enabled == want[app][1]
