"""Host time inside the fused megastep calls per engine step: the
program's ``dispatch_ns`` counter (its ``executor.megastep`` spans, one
per group call) over the window's ``steps``.  None where the program
keeps no such counter."""


def read(rec):
    c = rec.get("counters") or {}
    if "dispatch_ns" not in c or not c.get("steps"):
        return None
    return c["dispatch_ns"] / c["steps"] / 1e6
