"""Paged decode attention: every decode token of the traced slice over its
cached keys."""
from servebench import counts
from servebench.metrics._roofline import share


def _work(d, steps, _ranks):
    return counts.sum_pairs(counts.paged_decode(d, keys)
                            for s in steps for _, keys in s["decode"])


def read(rec):
    return share(rec, "paged_attention", _work)
