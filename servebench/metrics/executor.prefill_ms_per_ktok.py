"""Host time inside the prefill calls per 1,000 real prompt tokens: the
program's ``prefill_ns`` counter (its ``executor.prefill`` spans, each
ending in the copy of the first tokens to the host) over its
``prefill_tokens`` in the window.  None where the program keeps no such
counters or prefilled nothing."""


def read(rec):
    c = rec.get("counters") or {}
    if "prefill_ns" not in c or not c.get("prefill_tokens") \
            or not c.get("steps"):
        return None
    return c["prefill_ns"] / c["prefill_tokens"] / 1e3
