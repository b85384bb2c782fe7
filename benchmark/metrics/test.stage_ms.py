"""Milliseconds per `t` operation in `ops/sha1.stage_bytes`: the gather of
decoded blocks into pinned host memory and the copy's launch."""


def read(trace):
    if not trace.ops:
        return None
    return 1000.0 * trace.span_seconds("stage_bytes") / len(trace.ops)
