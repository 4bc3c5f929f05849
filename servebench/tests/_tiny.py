"""Small stand-ins for the cell's configuration and mix, for CPU runs of
the whole harness."""
import copy

from servebench import harness
from servebench.traffic import gen

DEMO = {"hidden_size": 256, "intermediate_size": 688,
        "num_attention_heads": 8, "num_key_value_heads": 4, "head_dim": 32,
        "num_hidden_layers": 4, "vocab_size": 512}
TINY = {"hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "num_hidden_layers": 2, "vocab_size": 256}


def config(model=TINY, dtype="bfloat16"):
    cfg = copy.deepcopy(harness.load_config("stablelm2-12b-zoo"))
    cfg["model"].update(model)
    cfg["serving"].update(num_pages=4000, max_active=8, max_block_batch=4,
                          max_len=200, dtype=dtype)
    cfg["check"].update(min_tokens=60, max_requests=12)
    return cfg


def mix(rate=10.0):
    m = copy.deepcopy(gen.load_mix("chat"))
    m.update(rate_rps=rate, preroll_s=0.4, preroll_inflight=3,
             prompt_len={"dist": "lognormal", "median": 24, "sigma": 0.7,
                         "min": 8, "max": 96},
             output_len={"dist": "lognormal", "median": 8, "sigma": 0.6,
                         "min": 4, "max": 32})
    return m


def run(seed=1234567890123, seconds=1.5, **kw):
    import time
    return harness.run_cell("zoo12b-chat", seed, seconds, False,
                            t_proc=time.perf_counter(), device="cpu", **kw)
