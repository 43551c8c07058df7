"""``idle_pct.train``: the share of the traced training window in which no
operation ran on the card, in %."""


def read(trace, window, run, cell):
    return trace.idle_pct()
