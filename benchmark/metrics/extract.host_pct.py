"""Per cent of the `x` operations' wall time outside the engine's
`decode_streams` calls: index, block reads, postprocessing, fragment
checks and file writes on the host (jidac/extract.py)."""


def read(trace):
    return trace.host_share_outside("decode_streams")
