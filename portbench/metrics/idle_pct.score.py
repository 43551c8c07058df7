"""``idle_pct.score``: the share of the traced scoring window in which no
operation ran on the card, in %."""


def read(trace, window, run, cell):
    return trace.idle_pct()
