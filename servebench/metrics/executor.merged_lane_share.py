"""Share of the plain fused lanes that ran in a merged walk over the lanes
of more than one chain (per-block batching across apps): the program's
``merged_lanes`` over its ``fused_lanes``, in the window.  None where the
program keeps no such counters or ran no plain fused lane."""


def read(rec):
    c = rec.get("counters") or {}
    if "merged_lanes" not in c or not c.get("fused_lanes"):
        return None
    return 100.0 * c["merged_lanes"] / c["fused_lanes"]
