"""Port parity for the run reports: ``pinnfc_tpu_torch.utils.tbevents`` against
the JAX package's (the same bytes, read by either package's ``read_events``),
``utils.observability``, and ``cli train --metrics-jsonl / --tensorboard-dir /
--profile-dir`` on the miniature campaign."""

import gzip
import json
import os
import types

import numpy as np
import pytest
import torch

from _torch_campaign import campaign  # noqa: F401  (fixture)
from pinnfc_tpu.cli import train as jax_cli_train
from pinnfc_tpu.utils import tbevents as jax_tb
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.cli import train as port_cli_train
from pinnfc_tpu_torch.utils import tbevents as port_tb
from pinnfc_tpu_torch.utils import checkpoint as port_checkpoint
from pinnfc_tpu_torch.utils import observability
from pinnfc_tpu_torch.utils.observability import (
    MetricsLogger, span, trace_profiler, write_chrome_trace)
from pinnfc_tpu_torch.utils.threads import one_thread


def test_crc32c_and_records_are_the_jax_bytes():
    rs = np.random.RandomState(0)
    for n in (0, 1, 9, 32, 1000):
        blob = rs.bytes(n)
        assert port_tb.crc32c(blob) == jax_tb.crc32c(blob)
        assert port_tb.masked_crc32c(blob) == jax_tb.masked_crc32c(blob)
    assert port_tb.crc32c(b"123456789") == 0xE3069283  # RFC 3720 check value
    for kw in (dict(wall_time=1.5, file_version="brain.Event:2"),
               dict(wall_time=2.25, step=-3, scalars={"loss/0:dnn": 0.5, "final/x": -1e30}),
               dict(wall_time=7.0, step=2**40, scalars={"é/τ": float("nan")})):
        assert port_tb._tfrecord(port_tb._event(**kw)) == jax_tb._tfrecord(jax_tb._event(**kw))


@pytest.mark.parametrize("writer,reader", [(port_tb, jax_tb), (jax_tb, port_tb)])
def test_event_files_cross_read(tmp_path, writer, reader):
    with writer.EventFileWriter(str(tmp_path)) as w:
        for step in range(5):
            w.add_scalar("loss/0:dnn", 1.0 / (step + 1), step=step, wall_time=10.0 + step)
        w.add_scalars({"final/voltage_mae": 0.125, "time/train_s": 3.5}, step=4,
                      wall_time=20.0)
    (name,) = os.listdir(tmp_path)
    assert name.startswith("events.out.tfevents.")
    events = reader.read_events(str(tmp_path / name))
    assert events == writer.read_events(str(tmp_path / name))
    assert [(e.step, e.tag) for e in events] == [
        *[(s, "loss/0:dnn") for s in range(5)], (4, "final/voltage_mae"), (4, "time/train_s")]
    np.testing.assert_array_equal([e.value for e in events],
                                  np.float32([1, 1 / 2, 1 / 3, 1 / 4, 1 / 5, 0.125, 3.5]))
    blob = bytearray((tmp_path / name).read_bytes())
    blob[-1] ^= 0xFF
    (tmp_path / name).write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        reader.read_events(str(tmp_path / name))


def test_metrics_logger_and_chrome_trace(tmp_path):
    ml = MetricsLogger()
    assert ml.latest() is None
    ml.log(step=0, loss=np.float32(0.5))
    ml.log(step=1, loss=0.25, event="final")
    ml.to_jsonl(str(tmp_path / "m.jsonl"))
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [(r["step"], r["loss"]) for r in rows] == [(0, 0.5), (1, 0.25)]
    assert ml.latest()["event"] == "final"
    with trace_profiler() as prof:
        with span("stage.dnn"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = write_chrome_trace(prof, str(tmp_path / "prof"))
    (name,) = os.listdir(tmp_path / "prof")
    assert path == str(tmp_path / "prof" / name) and name.endswith(".pt.trace.json.gz")
    with gzip.open(tmp_path / "prof" / name) as f:
        trace = json.load(f)
    names = [ev.get("name", "") for ev in trace["traceEvents"]]
    assert any("mm" in n for n in names)
    assert "pinnfc.stage.dnn" in names  # the program's spans, as --profile-dir writes them


def test_cli_train_writes_the_reports(campaign, tmp_path, capsys, monkeypatch):  # noqa: F811
    """One JSONL row per stage plus the final row, the event file with every
    stage's loss at every step, as the JAX ``_write_tensorboard`` writes it
    for the same run, and the profiler trace written after the checkpoint (the
    profiler itself stands in here: the test above traces and writes for real,
    and tracing every op of a CPU run costs seconds)."""
    d = tmp_path
    argv = ["train", "--device", "cpu", "--small", "--steps-scale", "0.02", "--normal-mat",
            campaign.config.normal_path, "--fault-dir", campaign.ascii_dir,
            "--mat-out", str(d / "t.mat"), "--ckpt", str(d / "ck"),
            "--metrics-jsonl", str(d / "m.jsonl"),
            "--tensorboard-dir", str(d / "tb"), "--profile-dir", str(d / "prof")]
    seen, order = {}, []
    real = port_cli_train._write_tensorboard
    real_save = port_checkpoint.save_checkpoint

    def keep(logdir, res):
        seen["res"] = res
        real(logdir, res)

    class Profiler:
        def __enter__(self):
            order.append("trace start")
            return self

        def __exit__(self, *exc):
            order.append("trace stop")

    def save(*a, **kw):
        order.append("checkpoint")
        real_save(*a, **kw)

    def write_trace(prof, log_dir):
        assert isinstance(prof, Profiler) and log_dir == str(d / "prof")
        order.append("trace written")
        return log_dir

    monkeypatch.setattr(port_cli_train, "_write_tensorboard", keep)
    monkeypatch.setattr(observability, "trace_profiler", Profiler)
    monkeypatch.setattr(observability, "write_chrome_trace", write_trace)
    monkeypatch.setattr(port_checkpoint, "save_checkpoint", save)
    with one_thread():  # many tiny ops: several threads per process stall under load
        assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "metrics JSONL →" in out and "tensorboard events →" in out
    res = seen["res"]
    n_iter = [len(losses) for _, losses in res.log.stages]
    assert n_iter == [6, 3, 3, 6, 10, 6, 6]

    rows = [json.loads(line) for line in open(d / "m.jsonl")]
    assert [r["event"] for r in rows] == ["stage"] * 7 + ["final"]
    assert [r["stage"] for r in rows[:7]] == [n for n, _ in res.log.stages]
    assert [r["n_iter"] for r in rows[:7]] == n_iter
    for r, (_, losses) in zip(rows, res.log.stages):
        assert r["final_loss"] == float(losses[-1])
        assert r["loss_trace"] == [float(v) for v in losses]
    assert {"voltage_mae", "train_s", "export_s"} <= set(rows[-1])

    (name,) = os.listdir(d / "tb")
    got = port_tb.read_events(str(d / "tb" / name))
    jax_dir = d / "tb_jax"
    jax_cli_train._write_tensorboard(str(jax_dir), types.SimpleNamespace(
        log=res.log, metrics=res.metrics, timings=res.timings))
    (jname,) = os.listdir(jax_dir)
    want = jax_tb.read_events(str(jax_dir / jname))
    assert [(e.step, e.tag) for e in got] == [(e.step, e.tag) for e in want]
    np.testing.assert_array_equal([e.value for e in got], [e.value for e in want])
    assert sum(e.tag.startswith("loss/") for e in got) == sum(n_iter)

    # a failed trace export cannot cost the trained model
    assert order == ["trace start", "trace stop", "checkpoint", "trace written"]
