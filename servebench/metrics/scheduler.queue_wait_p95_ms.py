"""95th percentile of the engine's queue_wait_s samples (submit to admit)
observed in the window."""
from servebench.window import percentile


def read(rec):
    if not rec["queue_wait_exact"]:
        return None
    v = percentile(rec["queue_wait_s"], 95)
    return None if v is None else v * 1e3
