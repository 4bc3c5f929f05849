"""max_memory_allocated over the window, after a reset at its start."""


def read(rec):
    return rec["window_peak_bytes"] / 2 ** 30 if rec["window_peak_bytes"] \
        else None
