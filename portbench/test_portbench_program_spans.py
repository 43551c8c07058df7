"""The readers of the program's own spans and counters on events made by
hand: each metric's arithmetic, and None where the spans or the counter are
absent, as at a commit whose program records none."""

import sys
import types

import pytest

from portbench.harness import Trace, Window, metric_reader

MS = 1_000_000  # ns
US = 1_000  # ns
CUDA = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"))
CPU = types.SimpleNamespace(device=types.SimpleNamespace(type="cpu"))


def _read(name, trace, window=None, run=CUDA):
    return metric_reader(name).read(trace, window or Window({}, 1, 0), run, None)


def _score_trace():
    """Two requests.  Request 1 (0-10 ms): mc 0-2 (busy 1-2), residuals 2-3,
    to_host 3-6 (busy 3-5), smooth 6-8, assemble 8-10.  Request 2 (10-20 ms):
    mc 10-11, residuals 11-12, to_host 12-14 (busy 12-13), smooth 14-19,
    assemble 19-20."""
    device = [("mc_sample_kernel", 1 * MS, 2 * MS), ("Memcpy DtoH", 3 * MS, 5 * MS),
              ("mc_sample_kernel", 12 * MS, 13 * MS)]
    phases = [("mc", 0, 2), ("residuals", 2, 3), ("to_host", 3, 6), ("smooth", 6, 8),
              ("assemble", 8, 10), ("mc", 10, 11), ("residuals", 11, 12),
              ("to_host", 12, 14), ("smooth", 14, 19), ("assemble", 19, 20)]
    host = [("pinnfc.export", 0, 10 * MS), ("pinnfc.export", 10 * MS, 20 * MS),
            ("portbench.score", 0, 20 * MS), ("aten::copy_", 3 * MS, 4 * MS)]
    host += [(f"pinnfc.export.{n}", s * MS, e * MS) for n, s, e in phases]
    spans = [("portbench.score", 0, 20 * MS)]
    return Trace((0, 20 * MS), device, host, spans)


@pytest.mark.parametrize("name,want", [
    ("score_host_ms.mc", (1 + 1) / 2),  # 2 - 1 busy, then 1 - 0
    ("score_host_ms.smooth", (2 + 5) / 2),
    ("score_host_ms.assemble", ((3 - 2) + 2 + (2 - 1) + 1) / 2),
])
def test_score_parts_are_wall_less_busy_per_request(name, want):
    assert _read(name, _score_trace()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["score_host_ms.mc", "score_host_ms.smooth",
                                  "score_host_ms.assemble"])
def test_score_parts_none_without_spans_or_device(name):
    tr = _score_trace()
    bare = Trace(tr.window, tr.device, [h for h in tr.host if not h[0].startswith("pinnfc.")],
                 tr.spans)
    assert _read(name, bare) is None
    assert _read(name, Trace(tr.window, [], tr.host, tr.spans)) is None


def _train_trace():
    """Two DNN stages of 3 steps.  Stage 1 (0-100 us): a recorder 0-3, prep
    from 3, kernels from 10 to 60 us with idle 20-25 and 40-42 (a memset at
    5-8 before them does not start the extent).  Stage 2 (100-200 us): prep
    from 105, kernels 130-170, idle 150-160, a copy 170-175 after them.  A
    thermal stage's operation is not read."""
    device = [("Memset (Device)", 5 * US, 8 * US),
              ("void (anonymous namespace)::fwd_bwd_bf16_kernel(Step)", 10 * US, 20 * US),
              ("wgrad_bf16_kernel", 25 * US, 40 * US),
              ("adam_kernel", 42 * US, 60 * US),
              ("fwd_bwd_kernel<false>", 130 * US, 150 * US),
              ("finalize_kernel", 160 * US, 170 * US),
              ("Memcpy DtoH", 170 * US, 175 * US),
              ("adam_kernel", 210 * US, 220 * US)]
    host = [("pinnfc.stage.dnn", 0, 100 * US), ("pinnfc.stage.dnn", 100 * US, 200 * US),
            ("pinnfc.stage.thermal", 200 * US, 300 * US),
            ("pinnfc.train_dnn.prep", 3 * US, 9 * US),
            ("pinnfc.train_dnn.launch", 9 * US, 50 * US),
            ("pinnfc.train_dnn.prep", 105 * US, 120 * US)]
    return Trace((0, 300 * US), device, host, [])


def test_train_gap_is_idle_inside_the_kernel_extent_per_step():
    win = Window({}, 1, 0, counts={"steps": 6, "stages": 2})
    # (5 + 2) us in stage 1, 10 us in stage 2, over 6 steps
    assert _read("train_gap_us", _train_trace(), win) == pytest.approx(17 / 6)


def test_stage_edge_runs_from_prep_to_the_kernels_and_after_them():
    # stage 1: (10 - 3) + (100 - 60) us; stage 2: (130 - 105) + (200 - 170) us
    assert _read("stage_edge_ms", _train_trace()) == pytest.approx(0.051)
    tr = _train_trace()
    no_prep = Trace(tr.window, tr.device, [h for h in tr.host if "prep" not in h[0]], [])
    assert _read("stage_edge_ms", no_prep) is None


@pytest.mark.parametrize("name", ["train_gap_us", "stage_edge_ms"])
def test_train_parts_none_without_stage_spans_or_kernels(name):
    tr = _train_trace()
    win = Window({}, 1, 0, counts={"steps": 6, "stages": 2})
    no_spans = Trace(tr.window, tr.device, [h for h in tr.host if "stage.dnn" not in h[0]], [])
    no_kernels = Trace(tr.window, [d for d in tr.device if "kernel" not in d[0]], tr.host, [])
    assert _read(name, no_spans, win) is None
    assert _read(name, no_kernels, win) is None


def test_setup_once_is_the_sum_of_the_counter(monkeypatch):
    fake = types.ModuleType("pinnfc_tpu_torch.ops.build")
    fake.ONCE_S = {"load": 0.25, "launch.mc_dropout": 0.5, "dispatch.residuals_op": 6.0}
    monkeypatch.setitem(sys.modules, "pinnfc_tpu_torch.ops.build", fake)
    tr = Trace((0, 1), [], [], [])
    assert _read("setup_once_s", tr) == pytest.approx(6.75)
    assert _read("setup_once_s", tr, run=CPU) is None
    fake.ONCE_S = {}
    assert _read("setup_once_s", tr) is None
    del fake.ONCE_S  # a program without the counter
    assert _read("setup_once_s", tr) is None
