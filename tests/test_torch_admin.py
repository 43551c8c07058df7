"""Port parity: the operational commands — ``cli doctor``, ``warmup`` and
``bench`` with ``utils/{compilation_cache,memory,warmup,doctor}`` and
``pinnfc_tpu_torch/bench.py`` — against the JAX package's
``pinnfc_tpu/cli/admin.py``, its parsers and ``pinnfc_tpu/utils``.

What is held against JAX: the three parsers' flags (dest, option strings,
default, choices, type); every parser difference between the two packages,
which must be the listed ones; the production step names of
``production_lowerings`` (default and ``--small`` configs, with ``--ckpt``)
and of ``production_memory_report``; the ``warm_downstream`` stages; the
doctor's check names and their order; ``check_checkpoint`` on a JAX npz
checkpoint; the bench line's keys.  On the CPU there is no ``nvcc`` and no
card: the kernel library is stood in for by an empty file at
``ops/build.py::library_path()`` under a monkeypatched ``BUILD_DIR``, which
is all that the filesystem checks read.  Sizes are miniature: 300 normal
rows and 40 per fault segment, a few bench steps.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from pinnfc_tpu.cli import parser as jax_parser
from pinnfc_tpu.config import TrainConfig as JaxTrainConfig
from pinnfc_tpu.utils import checkpoint as jax_ckpt
from pinnfc_tpu.utils import doctor as jax_doctor
from pinnfc_tpu.utils import warmup as jax_warmup
from pinnfc_tpu_torch import bench, cli
from pinnfc_tpu_torch.cli._common import _small_schedule, _train_config
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.utils import doctor, memory, warmup
from pinnfc_tpu_torch.utils.compilation_cache import library_hash, resolve_compilation_cache
from pinnfc_tpu_torch.utils.threads import one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--small", "--n-normal", "300", "--n-fault", "40"]


class _Built(Exception):
    pass


def _commands(parser) -> dict:
    """{subcommand: {dest: (option strings, default, choices, type, required)}}."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default,
                            tuple(a.choices) if a.choices else None, a.type, a.required)
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


@pytest.fixture(scope="module")
def both_parsers():
    """(the port's commands, the JAX package's commands), the JAX parser
    caught as its ``main`` is about to parse."""
    def grab(self, *a, **k):
        raise _Built(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(_Built) as built:
            jax_parser.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return _commands(cli.build_parser()), _commands(built.value.args[0])


@pytest.mark.parametrize("command", ["doctor", "warmup", "bench"])
def test_admin_parsers_take_jax_flags(both_parsers, command):
    """Every JAX flag with its option strings, default, choices and type;
    ``doctor --platform`` takes ``cuda``/``cpu`` (JAX: any backend name), and
    ``warmup``/``bench`` add the port's ``--device``."""
    port, jax_cmds = (p[command] for p in both_parsers)
    assert set(port) - set(jax_cmds) == ({"device"} if command != "doctor" else set())
    for dest, flag in jax_cmds.items():
        if (command, dest) == ("doctor", "platform"):
            assert port[dest][2] == ("cuda", "cpu") and jax_cmds[dest][2] is None
            assert port[dest][:2] + port[dest][3:] == flag[:2] + flag[3:]
        else:
            assert port[dest] == flag, dest
    if command != "doctor":
        assert port["device"][1:3] == ("cuda", ("cuda", "cpu"))


def test_every_parser_difference_is_listed(both_parsers):
    """Across every subcommand of both packages, the differences are the
    port-only ``--device`` (on the commands that do device work),
    ``score --mc-times``, ``export-model --platforms`` (cpu,cuda),
    ``risk --backend`` (its ``torch`` backend, which ``jax`` names) and
    ``doctor --platform``'s choices; anything else fails."""
    port, jax_cmds = both_parsers
    assert set(port) == set(jax_cmds)
    diffs = {(c, d) for c in port for d in set(port[c]) | set(jax_cmds[c])
             if port[c].get(d) != jax_cmds[c].get(d)}
    device = {"train", "score", "ensemble", "auc", "gmm", "compare", "risk", "identify",
              "explain", "whatif", "monitor", "report", "run-all", "serve", "warmup", "bench"}
    assert diffs == {(c, "device") for c in device} | {
        ("score", "mc_times"), ("export-model", "platforms"), ("risk", "backend"),
        ("doctor", "platform")}
    assert all(d not in jax_cmds[c] for c, d in diffs if d in ("device", "mc_times"))


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """A build directory holding a stand-in for the built kernel library."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "build").mkdir()
    build.library_path().touch()
    return tmp_path / "build"


def _config(args):
    return _train_config(argparse.Namespace(seed=42, steps_scale=None, precision=None,
                                            skip_nonfinite=False, **args))


@pytest.fixture(scope="module")
def small_data():
    from pinnfc_tpu_torch.data.combine import combine_and_normalize
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data

    normal, faults = synthesize_stack_data(n_normal=300, n_fault=40, seed=42)
    return combine_and_normalize(normal, faults, seed=42, device="cpu")


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory, small_data):
    """A port checkpoint of flagship weights with the small campaign's
    scalers and a sidecar."""
    from pinnfc_tpu_torch.models.pinn import init_pinn
    from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint

    path = str(tmp_path_factory.mktemp("admin") / "ck")
    params = init_pinn(generator=torch.Generator().manual_seed(0), device="cpu")
    save_checkpoint(path, params, small_data.scaler_x, small_data.scaler_y,
                    meta={"created": "2026-01-01", "config": {"seed": 42}})
    return path


@pytest.mark.parametrize("small,ckpt", [(False, False), (True, False), (True, True)],
                         ids=["default", "small", "small+ckpt"])
def test_production_lowerings_names_are_jax_s(small_data, port_ckpt, small, ckpt):
    """The port's steps on the CPU carry the names of JAX's
    ``production_lowerings`` on the CPU (built lazily on both sides, so
    nothing runs or compiles here)."""
    cfg = _config({"small": small})
    jcfg = JaxTrainConfig(schedule=tuple(cfg.schedule), mc_times=cfg.mc_times, seed=42)
    path = port_ckpt if ckpt else None
    got = [name for name, _ in warmup.production_lowerings(cfg, small_data, path, block=16)]
    want = [name for name, _ in jax_warmup.production_lowerings(jcfg, small_data, path,
                                                                 block=16)]
    assert got == want
    assert ("monitor_step[b16]" in got) == ckpt and f"mc_vmap[{cfg.mc_times}]" in got


def _run_cli(capsys, *argv):
    with one_thread():
        rc = cli.main(list(argv))
    return rc, capsys.readouterr()


def test_warmup_writes_the_manifest_that_coverage_reads(build_dir, port_ckpt, capsys,
                                                        monkeypatch):
    """``cli warmup --device cpu --json`` runs every step (the monitor step
    too, with ``--ckpt``), records the library hash and writes the manifest;
    ``warmup_coverage`` then finds every program present, and after a change
    of the sources' hash every one stale, with ``ok`` still true."""
    rc, out = _run_cli(capsys, "warmup", "--device", "cpu", *SMALL, "--ckpt", port_ckpt,
                       "--block", "16", "--json")
    assert rc == 0, out.err
    doc = json.loads(out.out.strip().splitlines()[-1])
    names = [r["program"] for r in doc["programs"]]
    cfg = _config({"small": True})
    assert names[0] == "dnn[300]@lr0.01/s1000/g0.8" and names[-1] == "monitor_step[b16]"
    assert len(names) == len(set(names)) == 11
    key = library_hash(build.library_path())
    assert all(r["key"] == key and r["was_cached"] is None and r["compile_s"] >= 0
               for r in doc["programs"])
    manifest = json.loads((build_dir / warmup.MANIFEST_NAME).read_text())
    assert manifest["programs"] == {f"cpu:{n}": key for n in names}
    assert manifest["torch"] == torch.__version__
    cov = warmup.warmup_coverage()
    assert cov["ok"] and not cov["stale"] and cov["missing"] == []
    assert cov["present"] == sorted(manifest["programs"])
    assert doctor.check_warmup_coverage()["name"] == "warmup_coverage"

    moved = build.library_path().with_name("libpinnfc_kernels_0123456789abcdef.so")
    monkeypatch.setattr(build, "library_path", lambda: moved)
    cov = warmup.warmup_coverage()
    assert cov["ok"] and cov["stale"] and cov["present"] == []
    assert cov["missing"] == sorted(manifest["programs"]) and "STALE" in cov["detail"]
    assert len(cfg.schedule) == 7


def test_warmup_exit_codes_and_a_failed_build(build_dir, tmp_path, capsys):
    """A campaign with one of its two flags exits 2 (as JAX's command); CUDA
    asked for on a box without it exits 1; a failed build raises, with the
    manifest written for what ran before it, and is never replaced by the
    plain versions."""
    rc, out = _run_cli(capsys, "warmup", "--device", "cpu", *SMALL, "--normal-mat", "x.mat")
    assert rc == 2 and "BOTH" in out.err
    if not torch.cuda.is_available():
        rc, out = _run_cli(capsys, "warmup", *SMALL)
        assert rc == 1 and "CUDA" in out.err
    build.library_path().unlink()
    ran = []
    with pytest.raises(RuntimeError, match="nvcc"):
        warmup.warm_cache([("dnn[1]", lambda: ran.append(1))], device="cuda", verbose=False)
    assert ran == [] and json.loads((build_dir / warmup.MANIFEST_NAME).read_text())[
        "programs"] == {}


def test_warm_downstream_stages_are_jax_s(monkeypatch):
    """The four downstream pipelines, in JAX's order (its pipelines replaced
    by recorders, so nothing compiles), each run once on the port's side on
    the miniature artifact."""
    from _torch_artifact import miniature_artifact

    import pinnfc_tpu.diagnosis as jd
    import pinnfc_tpu.risk as jr

    jax_order = []
    for mod, name in ((jd, "run_auc_pipeline"), (jd, "run_gmm_pipeline"),
                      (jr, "run_risk_pipeline"), (jd, "run_compare_pipeline")):
        monkeypatch.setattr(mod, name, lambda results, n=name: jax_order.append(n))
    jax_warmup.warm_downstream(miniature_artifact(), verbose=False)
    with one_thread():
        records = warmup.warm_downstream(miniature_artifact(), device="cpu", verbose=False)
    stages = [n[len("run_"):-len("_pipeline")] for n in jax_order]
    assert [r["program"] for r in records] == [f"downstream:{s}:0" for s in stages]
    assert stages == ["auc", "gmm", "risk", "compare"]
    assert all(r["key"] is None and r["compile_s"] >= 0 for r in records)


def test_doctor_checks_in_jax_order(build_dir, port_ckpt):
    checks = doctor.run_doctor(skip_probe=True, ckpt=port_ckpt)
    want = jax_doctor.run_doctor(skip_probe=True, ckpt=port_ckpt)
    assert [c["name"] for c in checks] == [c["name"] for c in want] == [
        "versions", "environment", "compilation_cache", "warmup_coverage", "checkpoint"]
    assert all(c["ok"] and c["detail"] for c in checks)
    vers = checks[0]["versions"]
    assert vers["torch"] == torch.__version__ and set(vers) == {
        "python", "pinnfc_tpu_torch", "torch", "cuda", "numpy", "scipy"}
    assert set(checks[1]["env"]) == {"CUDA_VISIBLE_DEVICES", "CUDA_HOME", "CUDA_PATH"}


def test_compilation_cache_check(build_dir, tmp_path, monkeypatch):
    """A writable build directory with the library built is ok (nvcc or not);
    with neither nvcc nor the library it fails; a build directory under a
    regular file fails and says why."""
    cache = resolve_compilation_cache()
    assert cache == {"dir": str(build_dir), "library": str(build.library_path()),
                     "hash": library_hash(build.library_path()), "built": True}
    assert doctor.check_compilation_cache()["ok"]
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("no")))
    build.library_path().unlink()
    res = doctor.check_compilation_cache()
    assert not res["ok"] and res["nvcc"] is None and "NOT FOUND" in res["detail"]
    blocker = tmp_path / "a_file"
    blocker.write_text("x")
    monkeypatch.setattr(build, "BUILD_DIR", blocker / "build")
    res = doctor.check_compilation_cache()
    assert not res["ok"] and "not writable" in res["detail"]


@pytest.mark.parametrize("case", ["cpu", "cuda", "timeout", "exit", "no_marker"])
def test_backend_probe(case):
    """``--platform cpu`` probes the CPU; ``cuda`` on a box without a card
    fails and names CUDA, never reporting the CPU; a stalled, failing or
    silent subprocess comes back as a readable failure."""
    if case in ("cpu", "cuda"):
        if case == "cuda" and torch.cuda.is_available():
            pytest.skip("the box has a card: the card-only tests probe it")
        res = doctor.probe_backend(120, case)
        assert res["name"] == "backend_probe"
        if case == "cpu":
            assert res["ok"] and res["platform"] == "cpu" and res["capability"] is None
            assert res["detail"].startswith("cpu: 1x cpu")
        else:
            assert not res["ok"] and "CUDA" in res["detail"] and "platform" not in res
        return
    code = {"timeout": "import time; time.sleep(30)", "exit": "raise SystemExit(3)",
            "no_marker": "print('hello')"}[case]
    res = doctor._bounded_python(code, 0.5 if case == "timeout" else 60)
    assert not res["ok"]
    assert {"timeout": "timed out", "exit": "rc=3", "no_marker": "no doctor marker"}[case] \
        in res["error"]


def test_check_checkpoint(port_ckpt, tmp_path):
    """A port checkpoint and a JAX npz checkpoint read on the host, with the
    parameter count of JAX's own check; a missing path fails readably."""
    import jax

    from pinnfc_tpu.models.pinn import init_pinn as jax_init_pinn

    got = doctor.check_checkpoint(port_ckpt)
    assert got["ok"] and "scalers scaler_x+scaler_y" in got["detail"]
    assert "seed 42" in got["detail"] and got["meta"]["created"] == "2026-01-01"
    assert got["total_parameters"] == jax_doctor.check_checkpoint(port_ckpt)["total_parameters"]
    jpath = str(tmp_path / "jax_ck")
    params = jax.tree_util.tree_map(np.asarray, jax_init_pinn(jax.random.PRNGKey(0),
                                                              (8, 32, 32, 1)))
    jax_ckpt.save_params_npz({"params": params, "step": np.asarray(3)}, jpath + ".npz")
    got = doctor.check_checkpoint(jpath)
    assert got["ok"] and got["total_parameters"] == jax_doctor.check_checkpoint(jpath)[
        "total_parameters"] and "scalers absent" in got["detail"]
    got = doctor.check_checkpoint(str(tmp_path / "missing"))
    assert not got["ok"] and "missing" in got["detail"]


def test_check_artifact(port_ckpt, tmp_path, capsys):
    """An ``export-model`` artifact deserializes with its platforms and
    sidecar; garbage fails readably."""
    path = str(tmp_path / "scorer.pt2")
    rc, _ = _run_cli(capsys, "export-model", "--ckpt", port_ckpt, "--out", path,
                     "--platforms", "cuda")
    assert rc == 0
    got = doctor.check_artifact(path)
    assert got["ok"] and got["platforms"] == ["cuda"] and got["sidecar"] is not None
    assert "platforms cuda" in got["detail"] and "sidecar ok" in got["detail"]
    bad = tmp_path / "garbage.pt2"
    bad.write_bytes(b"not an artifact")
    got = doctor.check_artifact(str(bad))
    assert not got["ok"] and str(bad) in got["detail"]


def test_cli_doctor_exit_codes(build_dir, port_ckpt, capsys):
    rc, out = _run_cli(capsys, "doctor", "--skip-probe", "--json")
    checks = json.loads(out.out)
    assert rc == 0 and [c["name"] for c in checks][-1] == "warmup_coverage"
    rc, out = _run_cli(capsys, "doctor", "--skip-probe", "--ckpt", port_ckpt + "_missing")
    assert rc == 1 and "[FAIL] checkpoint" in out.out
    rc, out = _run_cli(capsys, "doctor", "--skip-probe")
    assert rc == 0 and out.out.startswith("[  ok] versions")


def test_production_memory_report_on_the_cpu(small_data):
    """On the CPU no step runs and every record is unavailable; the names are
    JAX's ``production_memory_report``'s: its steps and the fleet step."""
    cfg = _config({"small": True})
    got = memory.production_memory_report(cfg, n_normal=300, n_fault=40, device="cpu")
    jcfg = JaxTrainConfig(schedule=_small_schedule(), mc_times=200, seed=42)
    want = [n for n, _ in jax_warmup.production_lowerings(jcfg, small_data)]
    assert [r["program"] for r in got] == want + ["monitor_fleet[S64,b64]"]
    assert all(r == {"unavailable": True, "program": r["program"]} for r in got)
    assert memory.memory_report(lambda: pytest.fail("ran on the CPU"), "cpu") is None


def _jax_bench_keys():
    return re.findall(r'"(\w+)":', jax_bench.__doc__)


@pytest.fixture
def tiny_bench(monkeypatch):
    monkeypatch.setattr(bench, "N_TRAIN", 64)
    monkeypatch.setattr(bench, "STEPS", 3)
    monkeypatch.setattr(bench, "TORCH_STEPS", 2)


def test_bench_line_has_bench_py_keys(tiny_bench, capsys):
    """``cli bench --device cpu`` prints one JSON line with the root
    ``bench.py``'s keys; its FLOP count is ``bench.py``'s; no MFU on the
    CPU."""
    rc, out = _run_cli(capsys, "bench", "--device", "cpu")
    assert rc == 0
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert list(doc) == _jax_bench_keys()
    assert doc["metric"] == "pinn_train_steps_per_sec" and doc["unit"] == "steps/s"
    assert doc["value"] > 0 and doc["throughput_steady_steps_per_sec"] > 0
    assert doc["value"] == doc["steady_steps_per_sec"] and doc["vs_baseline"] > 0
    assert doc["mfu_pct"] is None and doc["throughput_mfu_pct"] is None
    assert bench.FLOPS_PER_STEP == jax_bench.FLOPS_PER_STEP == doc["flops_per_step"]
    if not torch.cuda.is_available():
        rc, out = _run_cli(capsys, "bench")
        assert rc == 1 and "CUDA" in out.err


_NO_JAX = (
    "import json, pathlib, sys\n"
    "sys.modules['jax'] = None\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "from pinnfc_tpu_torch import bench\n"
    "from pinnfc_tpu_torch.ops import build\n"
    "from pinnfc_tpu_torch.cli import main\n"
    "build.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
    "bench.N_TRAIN, bench.STEPS, bench.TORCH_STEPS = 64, 3, 2\n"
    "for argv in (['doctor', '--skip-probe', '--json'], ['bench', '--device', 'cpu']):\n"
    "    print(f'RC {main(argv)}', flush=True)\n"
    "assert not [m for m in sys.modules if m in ('pinnfc_tpu', 'bench')\n"
    "            or m.startswith('pinnfc_tpu.')]\n"
)


def test_doctor_and_bench_without_jax(build_dir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(build_dir)], cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert [ln for ln in lines if ln.startswith("RC ")] == ["RC 0", "RC 0"]
    assert list(json.loads(lines[-2])) == _jax_bench_keys()
