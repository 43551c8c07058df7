"""Staged training (counterpart of ``pinnfc_tpu/training``)."""
