"""Milliseconds per `t` operation reading the archive's index (the port's
span `jidac.index`)."""

from benchmark import program


def read(trace):
    return program.ms_per_op(trace, "jidac.index")
