"""Share of the lanes the megastep graphs' replays ran that were padding
(a group runs at its power-of-two lane bucket): the program's
``graph_lanes`` less ``graph_real_lanes``, over ``graph_lanes``, in the
window.  None where the program keeps no such counters or replayed
nothing."""


def read(rec):
    c = rec.get("counters") or {}
    if "graph_real_lanes" not in c or not c.get("graph_lanes"):
        return None
    return 100.0 * (c["graph_lanes"] - c["graph_real_lanes"]) / c["graph_lanes"]
