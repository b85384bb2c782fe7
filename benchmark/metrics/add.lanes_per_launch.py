"""Payloads (lanes) per `parallel/engine.encode_streams` call, over all
calls of the window's operations."""


def read(trace):
    calls = trace.of("encode_streams")
    if not calls:
        return None
    return sum(len(c.attrs["in_bytes"]) for c in calls) / len(calls)
