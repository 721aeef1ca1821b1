"""Plain PyTorch versions of the AQUA coalescing gather/scatter: the CPU
path of ``ops.py`` and the oracle the CUDA kernels are held against.

Ids outside [0, P) follow one contract on both devices: the gather writes a
zero row for such an id and the scatter writes nothing for it. (The
reference's Pallas kernels differ here: they wrap a negative id once and
clamp the result into the pool.) Neither function synchronises with the
device: the masks stay on it, so a timed run can queue them back to back.
"""
from __future__ import annotations

import torch


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row mask shaped to broadcast over ``like``'s page payload."""
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def gather_pages_ref(pool: torch.Tensor, page_ids: torch.Tensor
                     ) -> torch.Tensor:
    """pool: (P, *page); page_ids: (n,) -> staging (n, *page); the row of
    an id outside [0, P) is zero."""
    P, ids = pool.shape[0], page_ids.long()
    if P == 0:
        return pool.new_zeros((ids.shape[0],) + tuple(pool.shape[1:]))
    ok = (ids >= 0) & (ids < P)
    rows = pool[torch.where(ok, ids, 0)]
    return torch.where(_rows(ok, rows), rows, rows.new_zeros(()))


def scatter_pages_ref(pool: torch.Tensor, staging: torch.Tensor,
                      page_ids: torch.Tensor) -> torch.Tensor:
    """Write staging (n, *page) into pool at page_ids, in place, skipping
    ids outside [0, P); of duplicate ids the last one's row lands. Returns
    pool."""
    P, ids = pool.shape[0], page_ids.long()
    if P == 0 or ids.shape[0] == 0:
        return pool
    ok = (ids >= 0) & (ids < P)
    # the last staging row that targets each pool row (-1: none); out-of-
    # pool ids land on a sink entry P that is dropped
    order = torch.arange(ids.shape[0], device=ids.device)
    last = torch.full((P + 1,), -1, dtype=torch.long, device=ids.device)
    last = last.scatter_reduce(0, torch.where(ok, ids, P), order, "amax")[:P]
    new = staging.to(pool.dtype)[last.clamp(min=0)]
    pool.copy_(torch.where(_rows(last >= 0, pool), new, pool))
    return pool
