"""Milliseconds per `a` operation in the transaction's assembly and write
to the archive (the port's span `add.commit`)."""

from benchmark import program


def read(trace):
    return program.ms_per_op(trace, "add.commit")
