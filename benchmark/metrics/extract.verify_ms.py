"""Milliseconds per `x` operation in the host's SHA-1 check of the decoded
fragments (the port's span `extract.verify`)."""

from benchmark import program


def read(trace):
    return program.ms_per_op(trace, "extract.verify")
