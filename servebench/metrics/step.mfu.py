"""Model FLOPs of the window's served work (each prompt prefilled and each
decode token, counted once by counts.py) over the window's seconds at the
bf16 peak."""
from servebench import counts
from servebench.window import steps_between


def read(rec):
    d, ranks = rec["dims"], rec["lora_rank"]
    flops = 0.0
    for s in steps_between(rec, rec["w0"], rec["w1"]):
        for app, S in s["prefill"]:
            flops += counts.prompt_flops(d, S, ranks.get(app, 0))
        for app, keys in s["decode"]:
            flops += counts.token_flops(d, keys, ranks.get(app, 0))
    return 100.0 * flops / ((rec["w1"] - rec["w0"]) * counts.PEAK_BF16_FLOPS)
