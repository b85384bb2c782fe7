"""Per cent of the `t` operations' wall time outside
`jidac/extract._check_lanes` (staging, the SHA-1 launch and the digest
compare): the verify loop waiting for the host's block decodes."""


def read(trace):
    return trace.host_share_outside("check_lanes")
