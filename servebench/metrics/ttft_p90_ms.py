"""90th percentile of due-to-first-token time over every request due in
the window (one still waiting at the close counts its wait).  The 90th,
not the 95th: a window holds about 80 due requests, and a reported
percentile wants about ten samples beyond it."""
from servebench.window import percentile, ttft_s


def read(rec):
    v = percentile(ttft_s(rec), 90)
    return None if v is None else v * 1e3
