"""The plain reference that decides ``correct``: plain PyTorch and NumPy, written
from the published model (reference script 01) and the random-stream contract
of the port's kernels, importing nothing of the program under test.

- ``rounding``: operands rounded to a lower precision (bf16, TF32, fp8),
  for the stated precision of a configuration and for its control.
- ``masks``: the counter-based hash and the keep masks of MC dropout and of
  training.
- ``mlp``: the MLP's eval pass, MC-dropout sums, and training steps by
  autograd with Adam.
- ``campaign``: the MinMax scalers, the four physics residuals, the
  segment-wise smoothing and the 22-column artifact of a scored campaign.
- ``lambda_stages``: the λ stages' losses, their gradients, Adam and the
  box clamp.
- ``compare``: the gaps between the program's outputs and the reference's.
"""
