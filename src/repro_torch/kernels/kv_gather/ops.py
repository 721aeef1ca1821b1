"""Public wrappers for the AQUA coalescing gather/scatter.

Dispatch goes by the tensors' device: CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the kernels of ``csrc/kv_gather.cu`` (and
raise if they cannot). A page payload of any shape is moved as flat bytes,
the reference's ``_canon`` folding. Page ids are int32, on the pool's device.
An id outside [0, P) gathers a zero row and scatters nothing, on both
devices.

The gather's work plan (route, chunk, ring stages, grid) is computed here
by ``gather_plan``, a pure function of the shapes, the base addresses'
alignment and the card's SM count, and passed to the C entry: rows of a
multiple of 16 bytes on 16-byte-aligned bases take the bulk-copy kernel
(a persistent grid moving 16 KiB chunks through a shared-memory ring),
every other row the vector kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_gather.ref import (gather_pages_ref,
                                               scatter_pages_ref)

CHUNK_BYTES = 16 * 1024      # a work item: a page, or a 16 KiB slice of one
MIN_CHUNK_BYTES = 2 * 1024   # the finest slice when few rows must spread
STAGES = 6                   # ring stages of one block, a chunk each
BLOCKS_PER_SM = 2
ROUTES = {"vector": 0, "bulk": 1}


class GatherPlan(NamedTuple):
    route: str          # "bulk" or "vector"
    chunk_bytes: int    # bulk: bytes of a work item (the row's last may be
                        # shorter); 0 on the vector route
    stages: int
    blocks: int

    @property
    def smem_bytes(self) -> int:
        return self.chunk_bytes * self.stages


def gather_plan(n: int, row_bytes: int, base_align: int,
                sm_count: int) -> GatherPlan:
    """The gather's work plan for ``n`` rows of ``row_bytes``, base addresses
    aligned to ``base_align`` bytes (only whether 16 divides it matters), on
    a card of ``sm_count`` SMs. Few, small rows are cut finer so that the
    work items still reach every block of the grid."""
    if row_bytes % 16 or base_align % 16:
        return GatherPlan("vector", 0, 0, 0)
    slots = sm_count * BLOCKS_PER_SM
    chunk = min(CHUNK_BYTES, row_bytes)
    while (n * -(-row_bytes // chunk) < slots
           and chunk // 2 >= MIN_CHUNK_BYTES):
        chunk = -(-(chunk // 2) // 16) * 16
    items = n * -(-row_bytes // chunk)
    return GatherPlan("bulk", chunk, STAGES, min(items, slots))


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
    out = torch.empty((page_ids.shape[0],) + tuple(pool.shape[1:]),
                      dtype=pool.dtype, device=pool.device)
    return _gather_into(pool, page_ids, out)


def _gather_into(pool, page_ids, out):
    """Launch the gather into ``out``; the row of an id outside the pool is
    written zero on the card, as the plain version does."""
    n = page_ids.shape[0]
    if n == 0:
        return out
    row_bytes = _row_bytes(pool)
    plan = gather_plan(n, row_bytes,
                       math.gcd(16, pool.data_ptr(), out.data_ptr()),
                       sm_count(pool.device.index or 0))
    rc = build.lib().aqua_gather_pages(
        pool.data_ptr(), page_ids.data_ptr(), out.data_ptr(), n, row_bytes,
        pool.shape[0], ROUTES[plan.route], plan.chunk_bytes, plan.stages,
        plan.blocks, build.stream_of(pool))
    build.check("gather_pages", rc)
    build.LAUNCHES["gather_pages"] += 1
    return out


def gather_kernel_info(plan: GatherPlan) -> dict:
    """Registers, local bytes (spills and stack) and dynamic shared memory of
    the bulk-copy gather at ``plan``'s chunk and stages, and the card's
    opt-in shared memory limit per block, as the loaded library reports
    them. Builds the library on first use."""
    out = (ctypes.c_int * 4)()
    build.check("gather_pages info", build.lib().aqua_gather_pages_info(
        plan.chunk_bytes, plan.stages, ctypes.addressof(out)))
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                smem_optin_bytes=out[3])


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
