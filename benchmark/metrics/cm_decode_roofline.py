"""The CM decode kernel's share of its roofline (roofline/cm_decode.py)."""


def read(trace):
    return trace.roofline_pct("cm_decode")
