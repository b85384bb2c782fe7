"""Milliseconds per `a` operation that the operation's thread stood waiting
for a job's host preparation to finish on the add's pool (the port's span
`add.prepare_wait`)."""

from benchmark import program


def read(trace):
    return program.ms_per_op(trace, "add.prepare_wait")
