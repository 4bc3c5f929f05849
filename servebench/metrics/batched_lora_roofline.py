"""Batched LoRA: the LoRA apps' q and v projections over every prompt and
decode token they served in the traced slice, the weights read once per
step that served the app."""
from servebench import counts
from servebench.metrics._roofline import share


def _work(d, steps, ranks):
    flops = nbytes = 0.0
    for app, r in ranks.items():
        tokens = reads = 0
        for s in steps:
            n = (sum(S for a, S in s["prefill"] if a == app)
                 + sum(1 for a, _ in s["decode"] if a == app))
            tokens += n
            reads += n > 0
        f, b = counts.lora_qv(d, r, tokens, reads)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def read(rec):
    return share(rec, "batched_lora", _work)
