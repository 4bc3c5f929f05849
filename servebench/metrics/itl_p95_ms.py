"""95th percentile of every gap between consecutive deliveries of a
request's tokens, across all requests, ending in the window."""
from servebench.window import itl_s, percentile


def read(rec):
    v = percentile(itl_s(rec), 95)
    return None if v is None else v * 1e3
