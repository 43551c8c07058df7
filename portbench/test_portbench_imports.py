"""Nothing a cell runs loads JAX or the JAX package, compared by whole
top-level module names (``pinnfc_tpu_torch`` begins with ``pinnfc_tpu``);
the reference loads nothing of the port; ``run.py`` refuses without the
card and without the port."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.conftest import CELLS

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH="")


def _python(code: str, cwd: Path = ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV, capture_output=True,
                          text=True, timeout=600)


def test_forbidden_names_are_compared_whole():
    names = ["pinnfc_tpu_torch", "pinnfc_tpu_torch.ops.train_dnn", "numpy", "jaxtyping",
             "flax.linen", "jax", "jaxlib.xla_client", "pinnfc_tpu", "pinnfc_tpu.ops"]
    assert harness.forbidden_modules(names) == ["flax.linen", "jax", "jaxlib.xla_client",
                                                "pinnfc_tpu", "pinnfc_tpu.ops"]


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_loads_no_jax(name):
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import harness\n"
        "from portbench.conftest import run_tiny\n"
        f"res = run_tiny({name!r}, 4242)\n"
        "print(res['correct'], harness.forbidden_modules(list(sys.modules)))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'pinnfc_tpu_torch'}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    first, second = out.stdout.strip().splitlines()[-2:]
    assert first == "True []"
    assert second == "['pinnfc_tpu_torch']"


def test_reference_and_counts_load_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.reference.campaign, portbench.reference.mlp, "
        "portbench.reference.compare, portbench.reference.lambda_stages, portbench.counts, "
        "portbench.traffic._campaign\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'pinnfc_tpu_torch', 'pinnfc_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_the_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "paper.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.stdout == ""


def test_run_without_the_port_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys, time; sys.path.insert(0, '.')\n"
        "from portbench import harness\n"
        "harness.run_cell('paper.train', 1, 0.1, False, time.perf_counter(), device='cpu')\n")
    out = _python(code, cwd=tmp_path)
    assert out.returncode != 0
    assert "pinnfc_tpu_torch" in out.stderr
    assert out.stdout == ""
