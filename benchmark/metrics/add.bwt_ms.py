"""Milliseconds per `a` operation in the BWT of the jobs' bytes on the host
(the port's span `pre.bwt`, inside `add.prepare`)."""

from benchmark import program


def read(trace):
    return program.ms_per_op(trace, "pre.bwt")
