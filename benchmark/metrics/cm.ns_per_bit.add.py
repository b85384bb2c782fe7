"""Nanoseconds a coded bit of the CM encode lanes: the lanes' summed
start-to-end on the card's clock (``lane_ns``) over their summed coded
bits (``lane_bits``, 8 x each lane's payload bytes), over the window's
``cm.wait`` spans. None where the port counts no ``lane_bits``."""

from benchmark import program


def read(trace):
    waits = [r for r in program.of(trace, "cm.wait") or ()
             if "lane_ns" in r.counts and "lane_bits" in r.counts]
    bits = sum(sum(r.counts["lane_bits"]) for r in waits)
    if bits <= 0:
        return None
    return sum(sum(r.counts["lane_ns"]) for r in waits) / bits
