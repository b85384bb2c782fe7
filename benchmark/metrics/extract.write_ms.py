"""Milliseconds per `x` operation writing the restored files (the port's
span `extract.write`)."""

from benchmark import program


def read(trace):
    return program.ms_per_op(trace, "extract.write")
