"""Per cent of the traced window in which no kernel, copy or fill ran on
the card."""


def read(trace):
    return trace.idle_pct()
