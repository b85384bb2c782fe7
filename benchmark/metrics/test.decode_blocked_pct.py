"""Per cent of the `t` operations' wall time in which the verify loop waits
for the host's block decodes (the port's span `verify.decode_wait`)."""

from benchmark import program


def read(trace):
    waits = program.of(trace, "verify.decode_wait")
    total = trace.op_seconds()
    if waits is None or not total:
        return None
    return 100.0 * sum(r.seconds for r in waits) / total
