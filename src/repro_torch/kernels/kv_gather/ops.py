"""Public wrappers for the AQUA coalescing gather/scatter.

Dispatch goes by the tensors' device: CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the kernels of ``csrc/kv_gather.cu`` (and
raise if they cannot). A page payload of any shape is moved as flat bytes,
the reference's ``_canon`` folding. Page ids are int32, on the pool's device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_gather.ref import (gather_pages_ref,
                                               scatter_pages_ref)


def _row_bytes(pool: torch.Tensor) -> int:
    return math.prod(pool.shape[1:]) * pool.element_size()


def _check(name, pool, page_ids):
    if page_ids.dim() != 1 or page_ids.dtype != torch.int32:
        raise ValueError(f"{name}: page_ids must be a 1-D int32 tensor")
    build.require_cuda(name, pool, page_ids)


def gather_pages(pool: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """Coalesce pages ``pool[page_ids]`` into one contiguous staging buffer
    ``(n, *page)``."""
    if pool.device.type == "cpu":
        return gather_pages_ref(pool, page_ids)
    _check("gather_pages", pool, page_ids)
    n = page_ids.shape[0]
    out = torch.empty((n,) + tuple(pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    if n == 0:
        return out
    lib = build.lib()
    rc = lib.aqua_gather_pages(pool.data_ptr(), page_ids.data_ptr(),
                               out.data_ptr(), n, _row_bytes(pool),
                               pool.shape[0], build.stream_of(pool))
    build.check("gather_pages", rc)
    build.LAUNCHES["gather_pages"] += 1
    return out


def scatter_pages(pool: torch.Tensor, staging: torch.Tensor,
                  page_ids: torch.Tensor) -> torch.Tensor:
    """Write ``staging`` (n, *page) back into ``pool`` at ``page_ids``, in
    place; returns ``pool``."""
    if pool.device.type == "cpu":
        return scatter_pages_ref(pool, staging, page_ids)
    _check("scatter_pages", pool, page_ids)
    staging = staging.to(pool.dtype).contiguous()
    n = page_ids.shape[0]
    if tuple(staging.shape) != (n,) + tuple(pool.shape[1:]):
        raise ValueError(f"scatter_pages: staging {tuple(staging.shape)} "
                         f"does not match {n} pages of {pool.shape[1:]}")
    build.require_cuda("scatter_pages", pool, staging)
    if n == 0:
        return pool
    lib = build.lib()
    rc = lib.aqua_scatter_pages(pool.data_ptr(), staging.data_ptr(),
                                page_ids.data_ptr(), n, _row_bytes(pool),
                                pool.shape[0], build.stream_of(pool))
    build.check("scatter_pages", rc)
    build.LAUNCHES["scatter_pages"] += 1
    return pool
