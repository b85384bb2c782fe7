"""Milliseconds per `a` operation that the main thread waits for the hash
pool's next file digest (the port's span `add.digest_wait`)."""

from benchmark import program


def read(trace):
    return program.ms_per_op(trace, "add.digest_wait")
