"""Faults planted in the timed path, for showing that ``correct`` catches them
(``calibrate.py`` reads each one's numbers on the card; the tests see
``correct`` come out false on the CPU).  Each is a context manager that
stands a broken version in for one function of the port, looked up at call
time, and puts the real one back.

- ``unchanged_state``: every step of a DNN stage returns the weights it was
  given (the stage at learning rate 0), so the stage returns them too;
- ``lambda_unchanged``: the same of every λ stage;
- ``half_batch``: a DNN or λ stage on the first half of the rows, its mean
  taken over them;
- ``dropped_term``: the voltage residual without its concentration loss,
  in both λ_V stages;
- ``altered_answer``: the MC statistics of one row replaced by another row's;
- ``half_passes``: the MC statistics taken over half of the dropout passes.
"""

from __future__ import annotations

import contextlib

# the stages of run_schedule that each fault acts on
DNN = ("dnn",)
LAMBDA = ("lambda_v", "thermal", "hydrogen", "oxygen")


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


@contextlib.contextmanager
def lambda_unchanged():
    from pinnfc_tpu_torch.training import stages

    def make(real):
        def stage(*args, **kw):
            return real(*args, **dict(kw, lr=0.0))
        return stage

    with _stand_in(stages, "train_lambda_v_chunk", make), \
            _stand_in(stages, "train_residual_chunk", make):
        yield


def _half(t):
    return t[:t.shape[0] // 2].contiguous()


@contextlib.contextmanager
def half_batch():
    from pinnfc_tpu_torch.training import stages

    def dnn(real):
        def stage(mlp, x, y, *args, **kw):
            return real(mlp, _half(x), _half(y), *args, **kw)
        return stage

    def lambda_v(real):
        def stage(lam, opt_state, x, y, u_pred, *args, **kw):
            return real(lam, opt_state, _half(x), _half(y), _half(u_pred), *args, **kw)
        return stage

    def residual(real):
        def stage(lam, opt_state, x, *args, **kw):
            return real(lam, opt_state, _half(x), *args, **kw)
        return stage

    with _stand_in(stages, "train_dnn", dnn), \
            _stand_in(stages, "train_lambda_v_chunk", lambda_v), \
            _stand_in(stages, "train_residual_chunk", residual):
        yield


def dropped_term():
    from pinnfc_tpu_torch.physics.constants import N_CELLS
    from pinnfc_tpu_torch.training import stages

    def make(real):
        def residual(*args, **kw):
            out = real(*args, **kw)
            return out._replace(f=out.f - out.v_conc,
                                v_out_est_stack=out.v_out_est_stack - out.v_conc * N_CELLS,
                                v_conc=out.v_conc * 0.0)
        return residual

    return _stand_in(stages, "voltage_residual", make)


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


FAULTS = {"unchanged_state": unchanged_state, "lambda_unchanged": lambda_unchanged,
          "half_batch": half_batch, "dropped_term": dropped_term,
          "altered_answer": altered_answer, "half_passes": half_passes}
# the faults each traffic kind can have, and for a training fault the stages
# it acts on
FAULTS_OF = {"train_stages": ("unchanged_state", "lambda_unchanged", "half_batch",
                              "dropped_term"),
             "score_campaigns": ("altered_answer", "half_passes")}
STAGES_OF = {"unchanged_state": DNN, "lambda_unchanged": LAMBDA, "half_batch": DNN + LAMBDA,
             "dropped_term": ("lambda_v",)}


def faults_of(cell) -> tuple:
    """The faults a cell can have: its traffic kind's, less those that act
    on no stage the cell runs."""
    stages = {s["name"] for s in cell.traffic.get("stages", ())}
    return tuple(f for f in FAULTS_OF[cell.workload["traffic"]]
                 if f not in STAGES_OF or stages & set(STAGES_OF[f]))
