"""Run one cell of the benchmark of ``pinnfc_tpu_torch`` once, from the root
of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the number compared beside its limit on standard error, then one JSON
line on standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last).  Exits
with 2 and prints no result without the CUDA devices the cell asks for, and
with 3 if the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
