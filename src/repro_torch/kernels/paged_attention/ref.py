"""Plain PyTorch versions of the serving paths' paged kernels: the CPU path
of ``ops.py`` and the oracle the CUDA kernels are held against. They mirror
the reference's jnp oracles (``repro/kernels/paged_attention/ref.py``)
operation for operation."""
from __future__ import annotations

import math
from typing import Optional

import torch


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                        scale: Optional[float] = None):
    """Decode attention over split K and V page pools.

    q: (B,H,hd) one query token per sequence; k_pages/v_pages: (K,P,page,hd);
    block_tables: (B,pps) page ids per sequence; lengths: (B,) tokens present
    per sequence (keys at positions < lengths[b] attend; a sequence with
    lengths 0 gets the uniform mean over all pps * page keys).
    -> (B,H,hd)
    """
    B, H, hd = q.shape
    K, _, page, _ = k_pages.shape
    G = H // K
    pps = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    bt = block_tables.long()
    kg = k_pages[:, bt].movedim(1, 0).reshape(B, K, pps * page, hd)
    vg = v_pages[:, bt].movedim(1, 0).reshape(B, K, pps * page, hd)

    qg = q.reshape(B, K, G, hd)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, kg).float() * scale
    pos = torch.arange(pps * page, device=q.device)[None, None, None, :]
    mask = pos < lengths.long()[:, None, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bksd->bkgd", probs, vg)
    return out.reshape(B, H, hd)


def paged_attention_pool_ref(q, kv_pool, block_tables, lengths,
                             scale: Optional[float] = None):
    """The same over the fused page-major pool (P,2,K,page,hd)."""
    k_pages = kv_pool[:, 0].movedim(1, 0)              # (K,P,page,hd)
    v_pages = kv_pool[:, 1].movedim(1, 0)
    return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               scale=scale)


def paged_prefill_attention_pool_ref(q, kv_pool, block_tables, q_starts,
                                     scale: Optional[float] = None):
    """Chunked-prefill attention over the fused pool: chunk token t of
    sequence b sits at q_starts[b] + t and attends to keys at positions
    <= q_starts[b] + t, at every row (bucket padding included).

    q: (B,Tc,H,hd); kv_pool: (P,2,K,page,hd); block_tables: (B,pps);
    q_starts: (B,). -> (B,Tc,H,hd)
    """
    B, Tc, H, hd = q.shape
    _, _, K, page, _ = kv_pool.shape
    G = H // K
    pps = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    bt = block_tables.long()
    k_pages = kv_pool[:, 0].movedim(1, 0)              # (K,P,page,hd)
    v_pages = kv_pool[:, 1].movedim(1, 0)
    kg = k_pages[:, bt].movedim(1, 0).reshape(B, K, pps * page, hd)
    vg = v_pages[:, bt].movedim(1, 0).reshape(B, K, pps * page, hd)

    qg = q.reshape(B, Tc, K, G, hd)
    scores = torch.einsum("btkgd,bksd->bkgts", qg, kg).float() * scale
    k_pos = torch.arange(pps * page, device=q.device)[None, None, None, None]
    q_pos = (q_starts.long()[:, None]
             + torch.arange(Tc, device=q.device)[None, :])[:, None, None, :,
                                                          None]
    scores = torch.where(k_pos <= q_pos, scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bksd->bkgtd", probs, vg)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tc, H, hd)


def paged_mixed_attention_pool_ref(q, kv_pool, block_tables, q_starts,
                                   n_reals, is_decode,
                                   scale: Optional[float] = None):
    """Mixed-mode (decode lanes + prefill chunk rows) paged attention.

    q: (R,Tc,H,hd); kv_pool: (P,2,K,page,hd); block_tables: (R,pps);
    q_starts/n_reals/is_decode: (R,) per-row metadata — a decode lane is a
    one-token row at absolute position q_start whose tail rows are fully
    masked (a finite uniform mean, never read); a chunk row attends
    causally at every row, bucket padding included.
    -> (R,Tc,H,hd)
    """
    R, Tc, H, hd = q.shape
    _, _, K, page, _ = kv_pool.shape
    G = H // K
    pps = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    pages = kv_pool[block_tables.long()]               # (R,pps,2,K,page,hd)
    kg = pages[:, :, 0].permute(0, 2, 1, 3, 4).reshape(R, K, pps * page, hd)
    vg = pages[:, :, 1].permute(0, 2, 1, 3, 4).reshape(R, K, pps * page, hd)

    qg = q.reshape(R, Tc, K, G, hd)
    scores = torch.einsum("btkgd,bksd->bkgts", qg, kg).float() * scale
    k_pos = torch.arange(pps * page, device=q.device)[None, None, None, None]
    t = torch.arange(Tc, device=q.device)[None, :]
    dec = is_decode.long()[:, None] != 0
    q_pos = (q_starts.long()[:, None]
             + torch.where(dec, 0, t))[:, None, None, :, None]
    valid = (k_pos <= q_pos) \
        & (~dec | (t < n_reals.long()[:, None]))[:, None, None, :, None]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bksd->bkgtd", probs, vg)
    return out.permute(0, 3, 1, 2, 4).reshape(R, Tc, H, hd)


def append_kv_ref(kv_pool, k_new, v_new, slots, offsets):
    """Page-append writer, in place: pool[slots[b], 0|1, :, offsets[b]] =
    k_new[b] / v_new[b]. kv_pool: (P,2,K,page,hd); k_new/v_new: (B,K,hd).
    Returns the pool."""
    slots, offsets = slots.long(), offsets.long()
    kv_pool[slots, 0, :, offsets] = k_new.to(kv_pool.dtype)
    kv_pool[slots, 1, :, offsets] = v_new.to(kv_pool.dtype)
    return kv_pool


def write_kv_rows_ref(kv_pool, k_new, v_new, block_table, q_starts,
                      n_write):
    """The packed step's page writer, in place: for each row r and token
    t < n_write[r] at pos = q_starts[r] + t, pool[block_table[r, pos //
    page], 0|1, :, pos % page] = k_new[r, t] / v_new[r, t] — the
    page-append writer over every (row, token) pair with work. Positions
    before 0 or whose page index is at or past the table's width, and
    slots outside the pool, are skipped.

    kv_pool: (P,2,K,page,hd); k_new/v_new: (R,T,K,hd); block_table: (R,W);
    q_starts/n_write: (R,). Returns the pool.
    """
    P, _, _, page, _ = kv_pool.shape
    T, W = k_new.shape[1], block_table.shape[1]
    t = torch.arange(T, device=kv_pool.device)
    pos = q_starts.long()[:, None] + t[None, :]
    page_idx = torch.div(pos, page, rounding_mode="floor")
    live = (t[None, :] < n_write.long()[:, None]) & (pos >= 0) \
        & (page_idx < W)
    rows, cols = live.nonzero(as_tuple=True)
    slots = block_table.long()[rows, page_idx[rows, cols]]
    keep = (slots >= 0) & (slots < P)
    rows, cols, slots = rows[keep], cols[keep], slots[keep]
    return append_kv_ref(kv_pool, k_new[rows, cols], v_new[rows, cols],
                         slots, pos[rows, cols] % page)


def window_pages(Tc: int, page: int) -> int:
    """Pages a chunk's write window spans: ceil(Tc/page) + 1 (a mid-page
    chunk start touches one extra page)."""
    return Tc // page + (1 if Tc % page else 0) + 1


def write_chunk_pages(kv_pool, k, v, window, offset: int, *,
                      page_tokens: int):
    """The reference's chunk writer (``repro/layers/attention.py``), which
    the serving paths ran once per chunk row before ``write_kv_rows``:
    K/V (1,Tc,K,hd) of one chunk land at token row ``offset`` of the
    chunk's page WINDOW — the pages covering ``[q_start, q_start + Tc)``,
    gathered, row-updated and scattered back so rows written by earlier
    chunks survive a mid-page boundary. Kept as the old path's yardstick.

    kv_pool: (P,2,K,page,hd); window: (W,) int64 pool slots (padding points
    at the scratch page); offset: ``q_start % page_tokens``.
    """
    _, Tc, K, hd = k.shape
    W = window.shape[0]
    pages = kv_pool[window]                                 # (W,2,K,page,hd)
    flat = pages.permute(0, 3, 1, 2, 4).reshape(W * page_tokens, 2, K, hd)
    flat[offset:offset + Tc] = torch.stack([k[0], v[0]],
                                           dim=1).to(flat.dtype)
    kv_pool[window] = (flat.reshape(W, page_tokens, 2, K, hd)
                       .permute(0, 2, 3, 1, 4))
    return kv_pool
