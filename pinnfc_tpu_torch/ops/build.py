"""Build and load the port's CUDA kernels, and count their launches.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface, loaded with ``ctypes``.  Nothing is built at import: the first
wrapper call on a CUDA tensor builds, at most once per process.  The library
name carries a hash of the sources and flags, so an edited source rebuilds.
The build directory ``pinnfc_tpu_torch/build/`` is listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: the NaN sets and the logf/expf/powf/tanhf values must
# follow the JAX functions
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# the residual kernel follows the plain version op by op: no contracted FMAs
FILE_FLAGS = {"residuals.cu": ["-fmad=false"]}

# C signature of pinnfc_mc_dropout: x, n, 14 float32 weights and biases, 4 bf16
# wide weights, out, seed, block0, mc_times, thresh, inv_keep, stream
MC_DROPOUT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, *([ctypes.c_void_p] * 18),
                       ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
                       ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]

# csrc/residuals.cu's ResidualScalars: one pointer to each scalar tensor, of this
# many float32 values, in this order
RESIDUAL_SCALAR_SIZES = {"lam_v": 4, "lam_t": 5, "lam_h": 4, "lam_o": 4,
                         "sx_scale": 8, "sx_min": 8, "sy_scale": 1, "sy_min": 1}


class ResidualScalars(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in RESIDUAL_SCALAR_SIZES]


# launches per kernel entry; each wrapper adds one where it launches its kernel
# (train_dnn_grad and train_dnn_adam: the per-step entries of csrc/train_dnn.cu
# that a data-parallel DNN stage runs)
LAUNCHES: Dict[str, int] = {"mc_dropout": 0, "residuals": 0, "train_dnn": 0,
                            "train_dnn_grad": 0, "train_dnn_adam": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# host-clock seconds of the costs a process pays once, each timed apart from
# those timed inside it: "build" (nvcc, only when the hashed library is
# missing), "load" (ctypes.CDLL and bind), "launch.<kernel>" (an entry's first
# call through ``launch``: CUDA loads the kernel's module lazily there).  An
# eager residual call launches directly; the registered operator
# ``pinnfc_torch::residuals`` runs only in traced programs and is not timed here
ONCE_S: Dict[str, float] = {}


def reset_once() -> None:
    ONCE_S.clear()


def once(key: str, fn: Callable, *args):
    """``fn(*args)``; its first call per process (per ``reset_once``) is timed
    into ``ONCE_S[key]``, less the ``ONCE_S`` entries made inside it.  After
    that, one dict lookup."""
    if key in ONCE_S:
        return fn(*args)
    inner = sum(ONCE_S.values())
    t0 = time.perf_counter()
    out = fn(*args)
    ONCE_S[key] = time.perf_counter() - t0 - (sum(ONCE_S.values()) - inner)
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(repr((NVCC_FLAGS, sorted(FILE_FLAGS.items()))).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpinnfc_kernels_{digest.hexdigest()[:16]}.so"


class _Library:
    handle: Optional[ctypes.CDLL] = None


def build(verbose: bool = False) -> Path:
    """Compile (if the hashed library is missing) and return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    return once("build", _compile, lib, verbose)


def _compile(lib: Path, verbose: bool) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *FILE_FLAGS.get(src.name, []), "-Xptxas", "-v",
               "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    objs = []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(f"[nvcc {src.name}]\n{out.strip()}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = lib.with_name(lib.name + f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def edited_source(name: str, edits) -> str:
    """The text of ``csrc/<name>`` with each (old, new) of ``edits`` applied;
    raises if an old text is no longer there."""
    src = (CSRC / name).read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"csrc/{name} no longer contains {old[:60]!r}")
        src = src.replace(old, new)
    return src


def compile_variants(texts: Dict[str, str], out_dir: Path) -> Dict[str, tuple]:
    """Compile each source text of ``texts`` (all nvcc processes at once) into
    its own shared library under ``out_dir``: name -> (the loaded library,
    nvcc's log).  For measuring copies of a kernel with a part removed."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-Xptxas", "-v", "-shared", str(src), "-o",
               str(out_dir / f"{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        out[name] = (ctypes.CDLL(str(out_dir / f"{name}.so")), log)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use) with its C signatures."""
    if _Library.handle is not None:
        return _Library.handle
    path = build()
    _Library.handle = once("load", lambda: bind(ctypes.CDLL(str(path))))
    return _Library.handle


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# C signature of each entry: (argtypes, restype)
SIGNATURES = {
    "pinnfc_residuals": ([_P, _P, ctypes.c_longlong, ResidualScalars, _P, _I, _P], _I),
    "pinnfc_residuals_floor": ([_I, _P], _I),
    "pinnfc_mc_dropout": (MC_DROPOUT_ARGTYPES, _I),
    "pinnfc_train_dnn_layout": ([ctypes.POINTER(_I)], None),
    "pinnfc_train_dnn_workspace_floats": ([_I], ctypes.c_longlong),
    "pinnfc_train_dnn_bf16_scratch_bytes": ([_I], ctypes.c_longlong),
    # x, y, n, params, m, v, work, ints, losses, seed, t0, n_iter, lr, lr_step,
    # lr_gamma, thresh, inv_keep, inv_n, skip, bf16, stream
    "pinnfc_train_dnn": ([_P, _P, _I, _P, _P, _P, _P, _P, _P, _U, _I, _I, _F, _I, _F, _U, _F, _F,
                          _I, _I, _P], _I),
    # x, y, n, row_off, params, work, grad, loss, flag, seed, t, thresh, inv_keep,
    # inv_n, bf16, stream
    "pinnfc_train_dnn_grad": ([_P, _P, _I, _I, _P, _P, _P, _P, _P, _U, _I, _U, _F, _F, _I, _P],
                              _I),
    # params, m, v, grad, work, ints, lr, lr_step, lr_gamma, skip, stream
    "pinnfc_train_dnn_adam": ([_P, _P, _P, _P, _P, _P, _F, _I, _F, _I, _P], _I),
}
# the entries of csrc/train_dnn.cu
TRAIN_ENTRIES = tuple(name for name in SIGNATURES if name.startswith("pinnfc_train_dnn"))


def bind(handle: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Set the C signatures of the entries ``names`` (all when None) on
    ``handle``."""
    for name in SIGNATURES if names is None else names:
        entry = getattr(handle, name)
        entry.argtypes, entry.restype = SIGNATURES[name]
    return handle


def check(status: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a C entry."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel '{kernel}' failed to launch (cudaError {status})")


def launch(entry, kernel: str, device, *args) -> None:
    """Call the C entry ``entry`` with ``args`` and the current stream of the
    CUDA ``device``, with that device made the current one (an entry raises
    its kernels' shared-memory limits and launches on the current device, so
    a tensor on another card than the current one needs this), and raise on
    its error."""
    import torch

    with torch.cuda.device(device):
        status = once("launch." + kernel, entry, *args,
                      torch.cuda.current_stream(device).cuda_stream)
    check(status, kernel)
