"""Share of the fused group calls that a megastep graph's replay served:
the program's ``graph_replays`` over its ``group_calls``, in the window.
None where the program keeps no such counter or made no group call."""


def read(rec):
    c = rec.get("counters") or {}
    if "graph_replays" not in c or not c.get("group_calls"):
        return None
    return 100.0 * c["graph_replays"] / c["group_calls"]
