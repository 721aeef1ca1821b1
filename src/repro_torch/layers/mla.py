"""Multi-head latent attention (DeepSeek-V2) — ``repro/layers/mla.py``:
the paged latent plane's functions and the dense latent cache's.

A page of the ``mla`` token plane holds, per token, the normalised rank-r
latent and the shared roped key: ``(page, kv_lora + rope_dim)`` in the
compute dtype (576 elements a token on V2). Prefill chunks attend
non-absorbed (per-head K/V materialised from the latents); decode lanes
attend absorbed (the query taken through ``wuk`` into latent space, the
context back through ``wuv``). Pools are updated IN PLACE and returned,
as in the attention layers. The reference computes all of it in ``jnp``
(no Pallas kernel), so the products here are PyTorch's. Training and the
dense cache's prefill take ``mla_full``, the non-absorbed full-sequence
causal form; the dense cache (``MLACache``: the latents and roped keys
of positions [0, seq)) decodes absorbed (``mla_decode``), in place. On a
rank of a mesh the rules split the latent cache's columns:
``mla_prefill_sharded`` / ``mla_decode_sharded``; the partitioned train
step runs ``mla_train_sharded``.

Not ported: a low-rank query (``q_lora_rank > 0``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.partition import own_slices, pspec, splits
from repro_torch.layers.core import (Linear, RMSNorm, apply_rope, linear,
                                     linear_rows, rms_norm, select_update,
                                     whole)


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S, kv_lora)   normalised latent
    k_rope: torch.Tensor  # (B, S, rope_dim)  shared roped key


class MLA(nn.Module):
    """``wq`` (d, H (nope + rope)), ``wdkv`` (d, kv_lora + rope),
    ``kv_norm``, ``wuk`` (kv_lora, H nope), ``wuv`` (kv_lora, H v),
    ``wo`` (H v, d)."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = cfg.mla
        if m.q_lora_rank:
            raise NotImplementedError(f"{cfg.name}: a low-rank MLA query is "
                                      "not ported")
        d, H, dt = cfg.d_model, cfg.n_heads, cfg.dtype()
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        kw = dict(generator=generator)
        self.wq = Linear(d, H * qd, dt, device, **kw)
        self.wdkv = Linear(d, m.kv_lora_rank + m.qk_rope_head_dim, dt, device,
                           **kw)
        self.kv_norm = RMSNorm(m.kv_lora_rank, dt, device)
        self.wuk = Linear(m.kv_lora_rank, H * m.qk_nope_head_dim, dt, device,
                          **kw)
        self.wuv = Linear(m.kv_lora_rank, H * m.v_head_dim, dt, device, **kw)
        self.wo = Linear(H * m.v_head_dim, d, dt, device, **kw)


def latent_dim(cfg: ModelConfig) -> int:
    return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim


def _latents(p: MLA, cfg: ModelConfig, x, positions, rank=None):
    """x (B,T,d) -> normalised latents (B,T,kv_lora), roped keys
    (B,T,rope). With ``rank`` (a rank's shards) the latents are computed
    whole: ``wdkv`` gathered (the rules' column split does not line up
    with the cache's, and RoPE pairs dim i with i + 32); in training they
    feed the rank's own heads, so the norm's scale enters its work."""
    r = cfg.mla.kv_lora_rank
    c = (linear(p.wdkv, x) if rank is None
         else x @ whole(p.wdkv, "w", rank).to(x.dtype))
    c_kv = rms_norm(p.kv_norm, c[..., :r], cfg.rmsnorm_eps, rank)
    k_rope = apply_rope(c[..., r:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _queries(p: MLA, cfg: ModelConfig, x, positions, wq=None):
    """x (B,T,d) -> (q_nope, roped q_rope) of every head, or of the heads
    whose columns ``wq`` holds."""
    m = cfg.mla
    B, T, _ = x.shape
    q = (linear(p.wq, x) if wq is None else x @ wq.to(x.dtype)).reshape(
        B, T, -1, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim
                           + cfg.mla.qk_rope_head_dim)


def mla_full(p: MLA, cfg: ModelConfig, x, *, return_cache: bool = False):
    """Non-absorbed full-sequence causal MLA (training, prefill) — the
    reference's ``mla_full``: per-head K/V from the latents, the scores in
    the compute dtype then float32 under the causal mask, the
    probabilities cast back to the compute dtype. x (B,T,d) at positions
    [0, T) -> (B,T,d), and with ``return_cache`` also the latents and
    roped keys ((B,T,kv_lora), (B,T,rope)). Its q.k width (nope + rope,
    192 on V2) and v width (128) differ, which the flash kernels do not
    take: the products are PyTorch's."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    c_kv, k_rope = _latents(p, cfg, x, positions)
    ctx = _full_heads(cfg, x, positions, c_kv, k_rope, p.wq.w, p.wuk.w,
                      p.wuv.w)
    out = linear(p.wo, ctx)
    return (out, (c_kv, k_rope)) if return_cache else out


def _full_heads(cfg: ModelConfig, x, positions, c_kv, k_rope, wq, wuk, wuv):
    """``mla_full``'s attention for the heads whose columns ``wq``,
    ``wuk`` and ``wuv`` hold, over the whole latents -> ctx (B,T,heads x
    v)."""
    m = cfg.mla
    B, T, _ = x.shape
    q_nope, q_rope = _queries(None, cfg, x, positions, wq=wq)
    H = q_nope.shape[2]
    k_nope = (c_kv @ wuk.to(x.dtype)).reshape(B, T, H, m.qk_nope_head_dim)
    v = (c_kv @ wuv.to(x.dtype)).reshape(B, T, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, T, H, m.qk_rope_head_dim)], dim=-1)
    scores = torch.einsum("bthd,bshd->bhts", q, k) * _scale(cfg)
    ti = torch.arange(T, device=x.device)
    mask = (ti[None, :] <= ti[:, None])[None, None]
    scores = scores.float().masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, -1)


def make_mla_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None,
                   device=None) -> MLACache:
    m = cfg.mla
    dt = dtype or cfg.torch_compute_dtype()
    return MLACache(
        torch.zeros((batch, seq, m.kv_lora_rank), dtype=dt, device=device),
        torch.zeros((batch, seq, m.qk_rope_head_dim), dtype=dt,
                    device=device))


def fill_mla_cache(cache: MLACache, c_kv, k_rope) -> MLACache:
    """Write prefill latents (B,T,*) into positions [0, T), in place."""
    T = c_kv.shape[1]
    cache.c_kv[:, :T] = c_kv.to(cache.c_kv.dtype)
    cache.k_rope[:, :T] = k_rope.to(cache.k_rope.dtype)
    return cache


def _absorbed(p: MLA, cfg: ModelConfig, x, positions, c_kv, k_rope):
    """Absorbed attention of single tokens x (B,1,d) at ``positions``
    (B,1) over latents (B,S,kv_lora) and roped keys (B,S,rope) of
    positions [0, S): the query taken into latent space through ``wuk`` in
    the compute dtype, keys at positions <= pos, the context back through
    ``wuv``. -> (B,1,d)."""
    m = cfg.mla
    B = x.shape[0]
    H, dt = cfg.n_heads, x.dtype
    S = c_kv.shape[1]
    q_nope, q_rope = _queries(p, cfg, x, positions)
    wuk = p.wuk.w.to(dt).reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_eff = torch.einsum("bthd,chd->bthc", q_nope, wuk)
    scores = (torch.einsum("bthc,bsc->bhts", q_eff, c_kv)
              + torch.einsum("bthd,bsd->bhts", q_rope, k_rope)) * _scale(cfg)
    mask = (torch.arange(S, device=x.device)[None, :]
            <= positions[:, :1])[:, None, None, :]
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx_lat = torch.einsum("bhts,bsc->bthc", probs, c_kv)
    wuv = p.wuv.w.to(dt).reshape(m.kv_lora_rank, H, m.v_head_dim)
    ctx = torch.einsum("bthc,chd->bthd", ctx_lat, wuv)
    return linear(p.wo, ctx.reshape(B, 1, -1))


def mla_decode(p: MLA, cfg: ModelConfig, x, cache: MLACache, pos
               ) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed single-token decode over the dense latent cache. x:
    (B,1,d); pos: (B,) int positions on x's device. The new latent and
    roped key go into row ``pos`` in place, then the lane attends to
    positions <= pos. Returns (out (B,1,d), cache)."""
    positions = pos.reshape(-1, 1).expand(x.shape[0], 1)
    c_new, r_new = _latents(p, cfg, x, positions)
    select_update(cache.c_kv, c_new[:, 0], positions[:, 0])
    select_update(cache.k_rope, r_new[:, 0], positions[:, 0])
    return _absorbed(p, cfg, x, positions, cache.c_kv, cache.k_rope), cache


def window_rows(starts, Tc: int, page: int, pps_pad: int) -> np.ndarray:
    """Host arithmetic of the reference's chunk write: row r's Tc latents
    land from token row ``starts[r] % page`` of a window of ``pps_win``
    pages that ``dynamic_slice`` takes from table entry ``starts[r] //
    page``, clamped so the window fits the table. Returns (R, Tc) int64
    flat indices ``table_entry * page + row_in_page``."""
    starts = np.asarray(starts, np.int64).reshape(-1)
    pps_win = Tc // page + (1 if Tc % page else 0) + 1
    if pps_win > pps_pad:
        raise ValueError(f"a {Tc}-token chunk needs a {pps_win}-page window; "
                         f"the block table has {pps_pad}")
    win = np.clip(starts // page, 0, pps_pad - pps_win)
    j = (starts % page)[:, None] + np.arange(Tc)[None, :]
    return (win[:, None] + j // page) * page + j % page


def write_chunk_latent_pages(lat_pool, lat, block_table, rows):
    """Chunked prefill writes latent pages in place, every row of the chunk
    in one indexed write: ``lat`` (R, Tc, C) lands at the flat window
    indices ``rows`` (R, Tc) (``window_rows``, as a tensor on the pool's
    device) of each row's table ``block_table`` (R, pps_pad). All Tc
    columns are written, padding included, as the reference's window
    update does. A page named twice (scratch padding) takes one of its
    writes."""
    page = lat_pool.shape[1]
    slots = torch.gather(block_table.long(), 1, rows // page)
    lat_pool[slots, rows % page] = lat.to(lat_pool.dtype)
    return lat_pool


def _gather_latents(cfg: ModelConfig, lat_pool, block_table):
    """(B, pps) slots -> latents (B, pps*page, kv_lora), roped keys
    (B, pps*page, rope)."""
    pages = lat_pool[block_table.long()]               # (B, pps, page, C)
    allc = pages.reshape(pages.shape[0], -1, pages.shape[-1])
    r = cfg.mla.kv_lora_rank
    return allc[..., :r], allc[..., r:]


def _chunk_attention(p: MLA, cfg: ModelConfig, x, lat_pool, block_table,
                     positions):
    """Non-absorbed causal attention of chunk rows x (R,Tc,d) at
    ``positions`` (R,Tc) over the latents of ``block_table`` (R, pps)."""
    m = cfg.mla
    R, Tc, _ = x.shape
    H = cfg.n_heads
    c_all, r_all = _gather_latents(cfg, lat_pool, block_table)
    S = c_all.shape[1]
    k_nope = linear(p.wuk, c_all).reshape(R, S, H, m.qk_nope_head_dim)
    v = linear(p.wuv, c_all).reshape(R, S, H, m.v_head_dim)
    q_nope, q_rope = _queries(p, cfg, x, positions)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, r_all[:, :, None, :].expand(
        R, S, H, m.qk_rope_head_dim)], dim=-1)
    scores = torch.einsum("bthd,bshd->bhts", q, k) * _scale(cfg)
    mask = (torch.arange(S, device=x.device)[None, None, :]
            <= positions[:, :, None])[:, None]
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhts,bshd->bthd", probs, v)
    return linear(p.wo, ctx.reshape(R, Tc, -1))


def step_meta(q_starts, n_decode: int, Tc: int, page: int, pps_pad: int,
              device) -> dict:
    """Device copies of a call's MLA metadata, made once per step and
    shared by every layer: the decode lanes' positions (n_decode, 1), the
    chunk rows' token positions (R - n_decode, Tc) and their window write
    indices (``window_rows``)."""
    qs = np.asarray(q_starts, np.int64).reshape(-1)
    meta = {}
    if n_decode:
        meta["decode_positions"] = torch.as_tensor(
            qs[:n_decode, None]).to(device)
    if len(qs) > n_decode:
        starts = qs[n_decode:]
        meta["chunk_positions"] = torch.as_tensor(
            starts[:, None] + np.arange(Tc)[None, :]).to(device)
        meta["rows"] = torch.as_tensor(
            window_rows(starts, Tc, page, pps_pad)).to(device)
    return meta


def mla_prefill_chunk(p: MLA, cfg: ModelConfig, x, lat_pool, block_table,
                      q_start: int, *, read_pps: Optional[int] = None,
                      meta=None):
    """Chunked prefill MLA for ONE request.

    x: (1,Tc,d), one normed chunk at positions ``q_start + [0, Tc)``;
    lat_pool: (P,page,C); block_table: (pps_pad,) int32 LOCAL slots of the
    request's latent pages from position 0, scratch-padded, on the pool's
    device; q_start: host int; ``meta`` optionally the ``step_meta`` of
    the chunk (shared by every layer). The chunk's latents are written into
    their page window first, then the chunk attends (non-absorbed, causal)
    to every latent of the first ``read_pps`` pages. Returns
    (out (1,Tc,d), pool).
    """
    B, Tc, _ = x.shape
    if B != 1:
        raise ValueError(f"chunked prefill is per-request, got {B} rows")
    bt = block_table[None]
    if meta is None:
        meta = step_meta([q_start], 0, Tc, lat_pool.shape[1], bt.shape[1],
                         x.device)
    positions = meta["chunk_positions"]
    c_kv, k_rope = _latents(p, cfg, x, positions)
    write_chunk_latent_pages(lat_pool, torch.cat([c_kv, k_rope], dim=-1), bt,
                             meta["rows"])
    out = _chunk_attention(p, cfg, x, lat_pool, bt[:, :read_pps], positions)
    return out, lat_pool


def mla_decode_paged(p: MLA, cfg: ModelConfig, x, lat_pool, block_table,
                     pos, *, meta=None):
    """Absorbed single-token decode reading and writing the latent pool.

    x: (B,1,d); lat_pool: (P,page,C); block_table: (B,pps) int32 LOCAL
    slots on the pool's device (idle lanes on scratch); pos: (B,) host
    positions; ``meta`` optionally their ``step_meta``. Each lane's new
    latent goes into its tail page row in place, then the lane attends
    absorbed (``_absorbed``) to the gathered latents at positions <= pos.
    Returns (out (B,1,d), pool).
    """
    B = x.shape[0]
    page = lat_pool.shape[1]
    if meta is None:
        meta = step_meta(pos, B, 1, page, block_table.shape[1], x.device)
    positions = meta["decode_positions"]                 # (B,1)
    c_new, r_new = _latents(p, cfg, x, positions)
    pos_d = positions[:, 0]
    slot = torch.gather(block_table.long(), 1, (pos_d // page)[:, None])[:, 0]
    lat_pool[slot, pos_d % page] = torch.cat(
        [c_new, r_new], dim=-1)[:, 0].to(lat_pool.dtype)

    c_kv, k_rope = _gather_latents(cfg, lat_pool, block_table)   # (B,S,*)
    return _absorbed(p, cfg, x, positions, c_kv, k_rope), lat_pool


def mla_mixed_paged(p: MLA, cfg: ModelConfig, x, lat_pool, block_table,
                    q_starts, n_reals, *, n_decode: int,
                    read_pps: Optional[int] = None, meta=None):
    """Mixed-mode MLA of a packed engine step.

    x: (R,Tc,d) packed rows — rows ``[:n_decode]`` decode lanes (one real
    token at column 0, position ``q_starts[r]``), the rest chunk rows
    (``n_reals[r]`` real tokens from ``q_starts[r]``; 0 marks a bucket-pad
    row on scratch). lat_pool: (P,page,C); block_table: (R, pps_pad) on
    the pool's device; q_starts / n_reals: (R,) host arrays; ``meta``
    optionally the step's ``step_meta`` (shared by every layer).

    Each mode keeps its per-request math: the decode lanes run
    ``mla_decode_paged`` (absorbed; their tail columns are zero), then
    every chunk row's window is written in one indexed write and the chunk
    rows attend non-absorbed over the first ``read_pps`` pages. Returns
    (out (R,Tc,d), pool).
    """
    R, Tc, _ = x.shape
    qs = np.asarray(q_starts, np.int64).reshape(-1)
    if meta is None:
        meta = step_meta(qs, n_decode, Tc, lat_pool.shape[1],
                         block_table.shape[1], x.device)
    out_rows = []
    if n_decode:
        out_d, _ = mla_decode_paged(p, cfg, x[:n_decode, :1], lat_pool,
                                    block_table[:n_decode, :read_pps],
                                    qs[:n_decode], meta=meta)
        if Tc > 1:
            out_d = torch.cat([out_d, out_d.new_zeros(
                (n_decode, Tc - 1, out_d.shape[-1]))], dim=1)
        out_rows.append(out_d)
    if R > n_decode:
        xc, bt = x[n_decode:], block_table[n_decode:]
        positions = meta["chunk_positions"]
        c_kv, k_rope = _latents(p, cfg, xc, positions)
        write_chunk_latent_pages(lat_pool, torch.cat([c_kv, k_rope], dim=-1),
                                 bt, meta["rows"])
        out_rows.append(_chunk_attention(p, cfg, xc, lat_pool,
                                         bt[:, :read_pps], positions))
    out = out_rows[0] if len(out_rows) == 1 else torch.cat(out_rows, dim=0)
    return out, lat_pool


# ---------------------------------------------------------------------------
# The partitioned step (a rank's shards; ``distributed/partition.py``)
# ---------------------------------------------------------------------------
def _latent_split(specs: MLACache) -> bool:
    """Whether the rules split the latent cache's feature dims over
    ``model`` (both leaves alike); its positions are never split here."""
    if any(splits((e,)) for e in (specs.c_kv[1], specs.k_rope[1])):
        raise ValueError("an MLA cache split over its positions is not "
                         "taken by the partitioned step")
    split = splits(specs.c_kv)
    if splits(specs.k_rope) != split:
        raise ValueError("the MLA cache's latents and roped keys must "
                         "split alike")
    return split


def _mla_heads(p: MLA, cfg: ModelConfig, rank):
    """The heads [h0, h1) the rank computes and their ``wq``, ``wuk``,
    ``wuv`` columns: its own heads where the four projections' splits give
    it the same whole heads (``wo`` by rows), else every head from the
    weights gathered whole."""
    m = cfg.mla
    widths = ((p.wq, m.qk_nope_head_dim + m.qk_rope_head_dim, 1),
              (p.wuk, m.qk_nope_head_dim, 1), (p.wuv, m.v_head_dim, 1),
              (p.wo, m.v_head_dim, 0))
    heads = set()
    for w, width, dim in widths:
        lo, hi = rank.range(pspec(w, "w")[dim], w.w.shape[dim])
        heads.add((lo // width, hi // width) if lo % width == hi % width == 0
                  else None)
    if len(heads) == 1 and None not in heads:
        h0, h1 = heads.pop()
        return (h0, h1, *(rank.gather(w.w, pspec(w, "w"))
                          for w in (p.wq, p.wuk, p.wuv)))
    return (0, cfg.n_heads, *(whole(w, "w", rank)
                              for w in (p.wq, p.wuk, p.wuv)))


def _out_sharded(p: MLA, cfg: ModelConfig, ctx, h0: int, rank,
                 scatter=None):
    """The rank's features of ctx (B,T,(h1-h0) v) through its rows of
    ``wo``, all-reduced (reduce-scattered along ``scatter``: the train
    step's sequence parallelism)."""
    v = cfg.mla.v_head_dim
    flo, fhi = rank.range(pspec(p.wo, "w")[0], p.wo.w.shape[0])
    return linear_rows(p.wo, ctx[..., flo - h0 * v:fhi - h0 * v], flo, fhi,
                       rank, scatter)


def mla_prefill_sharded(p: MLA, cfg: ModelConfig, x, cache: MLACache,
                        specs: MLACache, rank) -> torch.Tensor:
    """``mla_full(return_cache=True)`` + ``fill_mla_cache`` on a rank: x
    (B,T,d) replicated over ``model``, ``cache`` the rank's block under
    ``specs`` (its columns of the latents and of the roped keys). The
    whole latent projection (``wdkv`` gathered: the rules' column split
    does not line up with the cache's, and RoPE pairs dim i with i + 32),
    the norm and RoPE on it, the rank's columns into its cache; then the
    rank's heads in full and its rows of ``wo``, all-reduced."""
    _latent_split(specs)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    c_kv, k_rope = _latents(p, cfg, x, positions, rank)
    T = x.shape[1]
    for buf, new, spec in ((cache.c_kv, c_kv, specs.c_kv),
                           (cache.k_rope, k_rope, specs.k_rope)):
        buf[:, :T] = new[own_slices(buf, spec, rank, (2,))].to(buf.dtype)
    h0, _, wq, wuk, wuv = _mla_heads(p, cfg, rank)
    ctx = _full_heads(cfg, x, positions, c_kv, k_rope, wq, wuk, wuv)
    return _out_sharded(p, cfg, ctx, h0, rank)


def mla_train_sharded(p: MLA, cfg: ModelConfig, x, rank, *,
                      sp: bool) -> torch.Tensor:
    """``mla_full`` in the partitioned train step, from the serving
    prefill's pieces: x (B,T,d), the rank's block of the positions (B, T /
    model, d) under sequence parallelism (``sp``), all-gathered along T
    (the causal attention reads every position), else the stream,
    replicated over ``model``, entering the rank's work. The latents
    computed whole (``wdkv`` gathered, ``kv_norm``'s scale entered), the
    rank's heads (``_mla_heads``) over them as ``mla_full`` computes them,
    the (B, heads, T, T) float32 scores included, then its rows of ``wo``,
    all-reduced, or reduce-scattered along T under ``sp``. Everything a
    rank computes feeds its own heads and rows: its gradients are its
    shares."""
    x = rank.all_gather(x, 1, "model") if sp else rank.enter(x)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    c_kv, k_rope = _latents(p, cfg, x, positions, rank)
    h0, _, wq, wuk, wuv = _mla_heads(p, cfg, rank)
    ctx = _full_heads(cfg, x, positions, c_kv, k_rope, wq, wuk, wuv)
    return _out_sharded(p, cfg, ctx, h0, rank, 1 if sp else None)


def mla_decode_sharded(p: MLA, cfg: ModelConfig, x, cache: MLACache, pos,
                       specs: MLACache, rank) -> torch.Tensor:
    """``mla_decode`` on a rank, contraction-parallel over the latent dim
    the cache splits: the new latent and roped key computed whole, the
    rank's columns written at row ``pos``; the rank's heads' absorbed
    queries all-gathered to every head; the scores' two partial einsums
    over the rank's columns all-reduced (``_absorbed``'s sum, so one rank
    is the unpartitioned step bit for bit); the softmax; the latent
    context on the rank's columns all-gathered whole; then ``wuv`` and
    the rank's rows of ``wo`` on its heads, all-reduced. The cache is
    updated in place."""
    m = cfg.mla
    split = _latent_split(specs)
    B, dt = x.shape[0], x.dtype
    positions = pos.reshape(-1, 1).expand(B, 1)
    c_new, r_new = _latents(p, cfg, x, positions, rank)
    cols = []
    for buf, new, spec in ((cache.c_kv, c_new, specs.c_kv),
                           (cache.k_rope, r_new, specs.k_rope)):
        cols.append(own_slices(buf, spec, rank, (2,))[2])
        select_update(buf, new[:, 0, cols[-1]], positions[:, 0])
    h0, h1, wq, wuk, wuv = _mla_heads(p, cfg, rank)
    q_nope, q_rope = _queries(p, cfg, x, positions, wq=wq)
    q_eff = torch.einsum("bthd,chd->bthc", q_nope, wuk.to(dt).reshape(
        m.kv_lora_rank, h1 - h0, m.qk_nope_head_dim))
    if h1 - h0 != cfg.n_heads:
        q_eff, q_rope = rank.all_gather(torch.cat([q_eff, q_rope], -1), 2,
                                        "model").split(
            [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    scores = (torch.einsum("bthc,bsc->bhts", q_eff[..., cols[0]], cache.c_kv)
              + torch.einsum("bthd,bsd->bhts", q_rope[..., cols[1]],
                             cache.k_rope))
    if split:
        scores = rank.all_reduce(scores, "model")
    scores = scores * _scale(cfg)
    S = cache.c_kv.shape[1]
    mask = (torch.arange(S, device=x.device)[None, :]
            <= positions[:, :1])[:, None, None, :]
    probs = torch.softmax(torch.where(mask, scores.float(), -1e30),
                          dim=-1).to(dt)
    ctx_lat = torch.einsum("bhts,bsc->bthc", probs, cache.c_kv)
    if split:
        ctx_lat = rank.all_gather(ctx_lat, -1, "model")
    ctx = torch.einsum("bthc,chd->bthd", ctx_lat[:, :, h0:h1], wuv.to(
        dt).reshape(m.kv_lora_rank, h1 - h0, m.v_head_dim))
    return _out_sharded(p, cfg, ctx.reshape(B, 1, -1), h0, rank)
