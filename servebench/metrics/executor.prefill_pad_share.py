"""Share of the prompt positions the prefill calls ran that were padding
(each prompt is run at its power-of-two bucket): the program's
``prefill_padded_tokens`` less ``prefill_tokens``, over
``prefill_padded_tokens``, in the window.  None where the program keeps
no such counters or prefilled nothing."""


def read(rec):
    c = rec.get("counters") or {}
    if "prefill_padded_tokens" not in c or "prefill_tokens" not in c \
            or not c.get("prefill_padded_tokens") or not c.get("steps"):
        return None
    padded = c["prefill_padded_tokens"]
    return 100.0 * (padded - c["prefill_tokens"]) / padded
