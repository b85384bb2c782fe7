"""Per cent of the `a` operations' wall time outside the engine's
`encode_streams` calls: the digest, plan, payloads, assembly and commit on
the host (jidac/add.py, the host engine's digest in native.py)."""


def read(trace):
    return trace.host_share_outside("encode_streams")
