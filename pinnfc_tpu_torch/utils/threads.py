"""CPU thread pinning for results compared bitwise."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def one_thread():
    """Pin torch's CPU threads to one and restore the count after: a CPU
    float32 matmul's last bit depends on how many threads MKL splits it over,
    which can change between two calls, so results compared bitwise come
    from one pinned thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
