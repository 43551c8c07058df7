"""The port's persistent cache (counterpart of
``pinnfc_tpu/utils/compilation_cache.py``).

The JAX package keeps XLA executables in a persistent compilation cache.  On
the card the port compiles nothing at run time but its kernel library: every
``csrc/*.cu`` built once by ``nvcc`` into the shared library that
``ops/build.py::library_path`` names by a hash of the sources and flags, in
the git-ignored ``pinnfc_tpu_torch/build/``.  A process that finds the
library for the current hash loads it; one that does not builds it on its
first kernel launch.  This module resolves and reports that cache.  It never
builds, and it has no switch: a missing library is built at the next launch,
never replaced by the plain versions.
"""

from __future__ import annotations

from typing import Dict


def library_hash(path) -> str:
    """The source hash in a library's file name
    (``libpinnfc_kernels_<hash>.so``)."""
    return path.name[len("libpinnfc_kernels_"):-len(".so")]


def resolve_compilation_cache() -> Dict:
    """The build directory, the current library's path and hash, and whether
    that library is built (``enable_compilation_cache``'s counterpart: the
    port's cache needs no enabling)."""
    from pinnfc_tpu_torch.ops import build

    lib = build.library_path()
    return {"dir": str(build.BUILD_DIR), "library": str(lib), "hash": library_hash(lib),
            "built": lib.exists()}
