"""PyTorch/CUDA port of ``pinnfc_tpu`` (PINN fault diagnosis for PEM fuel cells).

The package mirrors the JAX package's module paths.  It imports torch, numpy
and scipy only.  Every entry point takes an explicit ``device`` and defaults
to ``"cuda"``; a CUDA request without a card raises instead of running on the
CPU.  The hand-written CUDA kernels live in ``csrc/`` and are bound by the
wrappers in ``ops/``; on CPU tensors those wrappers run their plain PyTorch
versions.
"""

from pinnfc_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
