"""The SHA-1 lane kernel's share of its roofline (roofline/sha1_lanes.py)."""


def read(trace):
    return trace.roofline_pct("sha1_lanes")
