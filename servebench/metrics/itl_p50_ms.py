"""Median of every gap between consecutive deliveries of a request's
tokens, across all requests, ending in the window: the decode pace a
streaming tenant sees.

The gaps come in two populations: those that end on a decode-only step
and those that end on a step that also carries a batched prefill,
several times longer.  The median reads the first while that share of
the gaps stays well under half (3.4-6.4% in the chat cell); within that
range it moves with the decode step, not with the share.  No tail of
these gaps is a metric: in the chat cell the 95th to 99th percentiles
rest on a few tens of prefill steps, and spread too widely between runs
of one seed to be judged."""
from servebench.window import itl_s, percentile


def read(rec):
    v = percentile(itl_s(rec), 50)
    return None if v is None else v * 1e3
