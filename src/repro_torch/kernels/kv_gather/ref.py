"""Plain PyTorch versions of the AQUA coalescing gather/scatter: the CPU
path of ``ops.py`` and the oracle the CUDA kernels are held against."""
from __future__ import annotations

import torch


def gather_pages_ref(pool: torch.Tensor, page_ids: torch.Tensor
                     ) -> torch.Tensor:
    """pool: (P, *page); page_ids: (n,) -> staging (n, *page)."""
    return pool[page_ids.long()]


def scatter_pages_ref(pool: torch.Tensor, staging: torch.Tensor,
                      page_ids: torch.Tensor) -> torch.Tensor:
    """Write staging (n, *page) into pool at page_ids, in place; returns
    pool."""
    pool[page_ids.long()] = staging.to(pool.dtype)
    return pool
