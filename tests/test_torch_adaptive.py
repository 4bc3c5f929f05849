"""Adaptive assembly (paper claim 1, Fig. 20) in the port against the JAX
reference: ``vocab_probability_similarity`` (float64 on the host, within
1e-12 of JAX's on the same arrays), ``BlockZoo.equivalent_blocks`` (JAX's
list on a zoo of JAX's parameters; scores, float64 sums in another order,
within 1e-9), ``shared_param_fraction`` (exactly
equal) and ``adaptive_serving_similarity`` on vicuna (JAX's swapped count
and, in fp32, its similarity within 1e-5; the JAX engine runs in an fp32
subprocess)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.equivalence import vocab_probability_similarity
from repro_torch.core.peft import shared_param_fraction
from repro_torch.serving.engine import (
    BlockEngine,
    EngineConfig,
    adaptive_serving_similarity,
)

PROMPT_SEED, N_PROMPTS, PROMPT_LEN, GEN_LEN = 7, 2, 16, 4


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


@pytest.fixture(scope="module")
def zoos(trees):
    from test_torch_blocks import jax_zoo, port_zoo

    return jax_zoo(*trees), port_zoo(*trees)


def _prompts(vocab: int) -> np.ndarray:
    return np.random.RandomState(PROMPT_SEED).randint(
        0, vocab, size=(N_PROMPTS, PROMPT_LEN)).astype(np.int32)


@pytest.mark.parametrize("as_torch", [False, True])
def test_vocab_probability_similarity_matches_jax(as_torch):
    from repro.core.equivalence import vocab_probability_similarity as jax_sim

    rng = np.random.RandomState(3)
    a = rng.dirichlet(np.ones(64), size=(3, 5)).astype(np.float32)
    b = (a + 0.01 * rng.rand(3, 5, 64)).astype(np.float32)
    want = jax_sim(jnp.asarray(a), jnp.asarray(b))
    got = vocab_probability_similarity(
        *((torch.from_numpy(a), torch.from_numpy(b)) if as_torch else (a, b)))
    assert abs(got - want) <= 1e-12


def test_equivalent_blocks_match_jax(zoos):
    jz, pz = zoos
    assert sorted(pz.blocks) == sorted(jz.blocks)
    for bid in jz.blocks:
        got, want = pz.equivalent_blocks(bid), jz.equivalent_blocks(bid)
        assert [b for b, _ in got] == [b for b, _ in want], bid
        # the scores are float64 sums taken in another order (torch vs numpy)
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=0, atol=1e-9)
    vicuna_layer1 = jz.chains["vicuna"].steps[2].block_id
    assert [b for b, _ in pz.equivalent_blocks(vicuna_layer1)] == \
        [jz.chains["base"].steps[2].block_id]


def test_shared_param_fraction_equals_jax(trees):
    from repro.core.peft import shared_param_fraction as jax_frac
    from repro_torch.bridge import to_torch

    base, _, pefts = trees
    want = jax_frac(jax.tree.map(jnp.asarray, base),
                    [jax.tree.map(jnp.asarray, t) for t in pefts["lora"]])
    as_t = lambda t: jax.tree.map(  # noqa: E731
        lambda x: to_torch(np.asarray(x), device="cpu"), t)
    got = shared_param_fraction(as_t(base), [as_t(t) for t in pefts["lora"]])
    assert got == want
    assert shared_param_fraction(base, pefts["lora"]) == want  # numpy trees


_JAX_ADAPTIVE = """
import json
import numpy as np
from test_torch_blocks import jax_zoo
from repro.serving.engine import BlockEngine, adaptive_serving_similarity

zoo = jax_zoo(*TREES)
prompts = np.random.RandomState({seed}).randint(
    0, 512, size=({n}, {s})).astype(np.int32)
sim, n = adaptive_serving_similarity(zoo, BlockEngine(zoo, max_len=64),
                                     "vicuna", prompts, gen_len={g})
print(json.dumps([float(sim), int(n)]))
"""


def test_adaptive_serving_similarity_matches_jax_fp32(trees, zoos):
    from test_torch_blocks import jax_fp32_json

    _, pz = zoos
    want_sim, want_n = jax_fp32_json(_JAX_ADAPTIVE.format(
        seed=PROMPT_SEED, n=N_PROMPTS, s=PROMPT_LEN, g=GEN_LEN), trees)
    engine = BlockEngine(pz, max_len=64, config=EngineConfig(
        device="cpu", compute_dtype="float32"))
    sim, n = adaptive_serving_similarity(pz, engine, "vicuna",
                                         _prompts(512), gen_len=GEN_LEN)
    assert n == want_n >= 1
    assert abs(sim - want_sim) <= 1e-5, (sim, want_sim)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adaptive_quality_fig20(zoos, dtype):
    """tests/test_serving.py's Fig. 20 check on the port: at least one
    block swapped and the output distributions close (random weights;
    the paper reports 0.88 trained); the swap is counted per request."""
    _, pz = zoos
    engine = BlockEngine(pz, max_len=64, config=EngineConfig(
        device="cpu", compute_dtype=dtype))
    sim, n = adaptive_serving_similarity(pz, engine, "vicuna",
                                         _prompts(512), gen_len=GEN_LEN)
    assert n >= 1
    assert sim > 0.6
    res = engine.generate(pz.chains["vicuna"], _prompts(512), 2,
                          block_override={pz.chains["vicuna"].steps[2]
                                          .block_id: pz.chains["base"]
                                          .steps[2].block_id})
    assert res.adaptive_blocks_used == 1
    # an app with no equivalence edge serves unchanged
    assert adaptive_serving_similarity(pz, engine, "app-lora", _prompts(512),
                                       gen_len=2) == (1.0, 0)
