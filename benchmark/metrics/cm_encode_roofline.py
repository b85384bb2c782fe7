"""The CM encode kernel's share of its roofline (roofline/cm_encode.py)."""


def read(trace):
    return trace.roofline_pct("cm_encode")
