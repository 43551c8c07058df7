"""Each cell on the card at its own size with a short window: correct, and
its control judged incorrect.  Skipped without a CUDA card (decided inside
each test)."""

import time

import pytest

from portbench import harness
from portbench.conftest import CELLS


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(name):
    _card()
    res = harness.run_cell(name, 3_141_592_653, 1.0, False, time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_incorrect_on_the_card(name):
    _card()
    res = harness.run_cell(name, 2_718_281_828, 1.0, False, time.perf_counter(), control=True)
    assert res["correct"] is False, res["checks"]
