"""Shared by the ``<kernel>.roofline`` readers: the traced slice's least
time for a layer's work over the device time of the kernels that carry
the layer's name."""
from servebench import counts
from servebench.window import steps_between


def share(rec, kernel: str, work):
    """``work(dims, steps, lora_ranks)`` -> (flops, bytes) of the traced
    steps; None where no such kernel ran or the work is nil."""
    tr = rec.get("trace")
    if not tr:
        return None
    t = sum(b - a for name, a, b in tr["kernels"] if kernel in name)
    if t <= 0:
        return None
    flops, nbytes = work(rec["dims"], steps_between(rec, *rec["traced"]),
                         rec["lora_rank"])
    if not flops and not nbytes:
        return None
    return 100.0 * counts.least_seconds(flops, nbytes) / t
