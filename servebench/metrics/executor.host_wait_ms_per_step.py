"""Host time blocked on the device per engine step: the program's
``host_wait_ns`` counter (its ``executor.wait`` spans around each copy that
waits for the device) over the window's ``steps``.  None where the program
keeps no such counter."""


def read(rec):
    c = rec.get("counters") or {}
    if "host_wait_ns" not in c or not c.get("steps"):
        return None
    return c["host_wait_ns"] / c["steps"] / 1e6
