"""Per cent of the decode pool's thread time spent decoding blocks: the
port's spans `verify.decode` over each `verify` span's seconds times its
threads."""

from benchmark import program


def read(trace):
    decodes = program.of(trace, "verify.decode")
    verifies = program.of(trace, "verify")
    if decodes is None or verifies is None:
        return None
    room = sum(r.seconds * r.counts["threads"] for r in verifies)
    if room <= 0:
        return None
    return 100.0 * sum(r.seconds for r in decodes) / room
