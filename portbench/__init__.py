"""The benchmark of the PyTorch/CUDA port ``pinnfc_tpu_torch`` on the card
(``BENCHMARK.json`` at the root of the repository; ``run.py`` runs one cell)."""
