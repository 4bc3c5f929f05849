"""Kernels launched on the device per engine step in the traced slice
(memory copies and sets are not launches)."""
from servebench.window import steps_between


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["kernels"]:
        return None
    lo, hi = rec["traced"]
    n_steps = len(steps_between(rec, lo, hi))
    if not n_steps:
        return None
    n = sum(1 for name, _, _ in tr["kernels"]
            if not name.startswith(("Memcpy", "Memset")))
    return n / n_steps
