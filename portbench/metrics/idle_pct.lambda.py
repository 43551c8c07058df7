"""``idle_pct.lambda``: the share of the traced window of λ stages
(``training/stages.py::_lambda_steps``) in which no operation ran on the
card, in %: above about half, the host paces the λ step."""


def read(trace, window, run, cell):
    return trace.idle_pct()
