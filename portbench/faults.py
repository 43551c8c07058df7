"""Faults planted in the timed path, for showing that ``correct`` catches them
(``calibrate.py`` reads each one's numbers on the card; the tests see
``correct`` come out false on the CPU).  Each is a context manager that
stands a broken version in for one function of the port, looked up at call
time, and puts the real one back.

- ``unchanged_state``: every step of a DNN stage returns the weights it was
  given (the stage at learning rate 0), so the stage returns them too;
- ``half_batch``: a DNN stage on the first half of the rows, its mean taken
  over them;
- ``altered_answer``: the MC statistics of one row replaced by another row's;
- ``half_passes``: the MC statistics taken over half of the dropout passes.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _stand_in(module, name: str, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def unchanged_state():
    from pinnfc_tpu_torch.training import stages

    def make(real):
        def stage(mlp, x, y, seed, n_iter, lr, *args, **kw):
            return real(mlp, x, y, seed, n_iter, 0.0, *args, **kw)
        return stage

    return _stand_in(stages, "train_dnn", make)


def half_batch():
    from pinnfc_tpu_torch.training import stages

    def make(real):
        def stage(mlp, x, y, *args, **kw):
            half = x.shape[0] // 2
            return real(mlp, x[:half].contiguous(), y[:half].contiguous(), *args, **kw)
        return stage

    return _stand_in(stages, "train_dnn", make)


def altered_answer():
    from pinnfc_tpu_torch.pipeline import export

    def make(real):
        def sampler(mlp, x, seed, mc_times=2000, dropout=0.4):
            mc = real(mlp, x, seed, mc_times, dropout)
            n = x.shape[0]
            r, src = n // 3, (n // 3 + n // 2) % n
            out = [t.clone() for t in mc]
            for t in out:
                t[r] = t[src]
            return type(mc)(*out)
        return sampler

    return _stand_in(export, "mc_dropout", make)


def half_passes():
    from pinnfc_tpu_torch.pipeline import export

    def make(real):
        def sampler(mlp, x, seed, mc_times=2000, dropout=0.4):
            return real(mlp, x, seed, max(1, mc_times // 2), dropout)
        return sampler

    return _stand_in(export, "mc_dropout", make)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "half_passes": half_passes}
# the faults each traffic kind can have
FAULTS_OF = {"train_stages": ("unchanged_state", "half_batch"),
             "score_campaigns": ("altered_answer", "half_passes")}
