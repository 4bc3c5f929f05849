"""Flash prefill attention: every prompt prefilled in the traced slice, at
its own length (not the bucket the program pads it to)."""
from servebench import counts
from servebench.metrics._roofline import share


def _work(d, steps, _ranks):
    return counts.sum_pairs(counts.flash_prefill(d, S)
                            for s in steps for _, S in s["prefill"])


def read(rec):
    return share(rec, "flash_attention", _work)
