"""Median of the engine's step_wall_s samples observed in the window."""
from servebench.window import percentile


def read(rec):
    if not rec["step_wall_exact"]:
        return None
    v = percentile(rec["step_wall_s"], 50)
    return None if v is None else v * 1e3
