"""Process start to window start: weights, registration, kernel libraries,
warm-up and the traffic's pre-roll."""


def read(rec):
    return rec["w0"] - rec["t_proc"]
