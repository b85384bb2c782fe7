"""Milliseconds per `a` operation in the jobs' host preparation before a CM
launch: the job's bytes, its preprocessing and a store block's coding
(the port's span `add.prepare`)."""

from benchmark import program


def read(trace):
    return program.ms_per_op(trace, "add.prepare")
