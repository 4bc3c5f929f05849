"""Most KV pages in use at any step end of the window, as a share of the
pages the pools can hand out (the engine's used/free page gauges)."""


def read(rec):
    return 100.0 * rec["kv_used_max"] / rec["kv_usable"]
