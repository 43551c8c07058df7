"""The benchmark's arithmetic against the shapes of the paper's MLP."""

import pytest

from portbench import counts

LAYERS = (8, 256, 256, 256, 1)
H100 = "NVIDIA H100 80GB HBM3"


def test_products_of_the_paper_mlp():
    assert counts.linears(LAYERS) == [(8, 256), (256, 256), (256, 256), (256, 1), (256, 128),
                                      (128, 64), (64, 1)]
    assert counts.param_count(LAYERS) == 175_362


def test_forward_flops_per_row_pass():
    assert counts.forward_flops_per_row(LAYERS) == 348_800


def test_train_flops_per_row_step_leave_out_layer_0_input_gradient():
    six = 6 * sum(i * o for i, o in counts.linears(LAYERS))
    assert six == 1_046_400
    assert counts.train_flops_per_row_step(LAYERS) == six - 4_096 == 1_042_304
    assert counts.train_flops_per_row_step(LAYERS) * 6_000 == 6_253_824_000


def test_mc_call_bound_is_bf16_compute():
    bound, which = counts.roofline(counts.mc_call(LAYERS, 15_600, 2_000), counts.peaks(H100))
    assert which == "compute"
    expected = 348_800 * 15_600 * (2_000 / 989.4e12 + 1 / 494.7e12)
    assert bound == pytest.approx(expected, rel=1e-12)
    assert bound == pytest.approx(11.01e-3, rel=1e-3)


@pytest.mark.parametrize("form, peak, us", [("tf32", 494.7e12, 12.64), ("bf16", 989.4e12, 6.32)])
def test_train_step_bound(form, peak, us):
    steps = 4_001
    bound, which = counts.roofline(counts.train_stage(LAYERS, 6_000, steps, form),
                                   counts.peaks(H100))
    assert which == "compute"
    assert bound / steps == pytest.approx(1_042_304 * 6_000 / peak, rel=1e-12)
    assert bound / steps * 1e6 == pytest.approx(us, abs=0.01)


def test_roofline_takes_the_larger_bound():
    peak = {"bf16_tflops": 1.0, "hbm_tb_s": 1.0}
    assert counts.roofline({"flops_bf16": 2e12, "bytes": 1e12}, peak) == (2.0, "compute")
    assert counts.roofline({"flops_bf16": 1e12, "bytes": 3e12}, peak) == (3.0, "memory")


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError):
        counts.peaks("cpu")
