"""The trace arithmetic of the per-layer readers on events made by hand."""

import pytest

from portbench.harness import Trace, short_name

MS = 1_000_000  # ns


def _trace():
    device = [("void (anonymous namespace)::k1<true>(Args)", 1 * MS, 3 * MS),
              ("k2(float*)", 2 * MS, 4 * MS),  # overlaps k1: counted once
              ("Memcpy DtoH", 6 * MS, 7 * MS)]
    spans = [("portbench.score", 0, 11 * MS // 2), ("portbench.score", 11 * MS // 2, 10 * MS)]
    host = spans + [("aten::copy_", 4 * MS, 6 * MS), ("cudaLaunchKernel", 8 * MS, 9 * MS)]
    return Trace((0, 10 * MS), device, host, spans)


def test_busy_time_is_the_union_of_device_operations():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(4e-3)
    assert tr.busy_s(2 * MS, 6 * MS + MS // 2) == pytest.approx(2.5e-3)
    assert tr.idle_pct() == pytest.approx(60.0)
    assert tr.window_s == pytest.approx(10e-3)


def test_host_time_per_span_is_wall_less_busy():
    # span 1: 5.5 ms wall, 3 ms busy; span 2: 4.5 ms wall, 1 ms busy
    assert _trace().host_ms_per_span(["portbench.score"]) == pytest.approx(3.0)
    # the sum over another divisor: 6 ms over 4 (stages, steps, ...)
    assert _trace().host_ms_per_span(["portbench.score"], 4) == pytest.approx(1.5)
    # the spans of several names together: the copy's 2 ms, none of it busy
    assert _trace().host_ms_per_span(["portbench.score", "aten::copy_"], 2) == \
        pytest.approx(4.0)
    assert _trace().host_ms_per_span(["portbench.run_schedule"]) is None
    assert _trace().host_ms_per_span(["portbench.score"], 0) is None
    # without the card's timeline there is no host part to split
    tr = _trace()
    assert Trace(tr.window, [], tr.host, tr.spans).host_ms_per_span(["portbench.score"]) is None


def test_device_time_by_kernel_name():
    seconds, launches = _trace().device_s(("k1", "k2"))
    assert launches == 2 and seconds == pytest.approx(4e-3)


def test_breakdown_names_gaps_by_the_innermost_host_event():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["k1<true>", pytest.approx(2e-3)]
    idle = dict(b["idle_gaps"])
    assert idle["portbench.score"] == pytest.approx(1e-3)  # 0-1 ms
    assert idle["aten::copy_"] == pytest.approx(2e-3)  # 4-6 ms
    assert idle["cudaLaunchKernel"] == pytest.approx(3e-3)  # 7-10 ms, middle in 8-9


def test_no_device_operation_reads_no_idle_share():
    assert Trace((0, MS), [], [], []).idle_pct() is None


def test_short_names():
    assert short_name("void (anonymous namespace)::fwd_bwd_kernel<false>(Step)") == \
        "fwd_bwd_kernel<false>"
    assert short_name("aten::mul") == "aten::mul"
