"""Per cent of the CM encode launches' lane time in which a lane still
ran: each lane's start-to-end on the card's clock over the launch's first
start to last end (the stamps under the port's span `cm.wait`)."""

from benchmark import program


def read(trace):
    return program.lane_busy_pct(trace)
