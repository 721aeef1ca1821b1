"""Mamba-1 selective SSM block (the Jamba hybrid's sequence mixer) — a port
of ``repro/layers/mamba.py`` under the same parameter names.

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t

Prefill runs the recurrence as a chunked scan: each chunk's transition
tensors (B, ck, di, ds) are built inside the chunk loop and combined by a
log-depth inclusive scan (the reference's ``associative_scan`` of the
same ``combine``), so at most one chunk's working set is live. Decode is a
single recurrence step over the per-request state, the state that AQUA
pages on the ``ssm`` and ``conv`` planes. The reference has no Pallas
kernel here: the products are ``torch.matmul`` and the scan PyTorch ops.

On a rank of a mesh (``mamba_sharded``; the reference constrains ``xz``
to the model axis and lets GSPMD split the rest) the conv runs on the
rank's channels of the conv state and the scan on its block of the ssm
state, whose d_state (or inner dim) the rules split over ``model``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.partition import (own_slices, shard_state,
                                                splits)
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.layers.core import (Linear, _param, linear,
                                     linear_gathered, linear_rows,
                                     trunc_normal, whole)

MAMBA_CHUNK = 128
# the most bytes of float32 transition tensors (a, b) scanned at once
MAMBA_GROUP_BYTES = 1 << 26


class MambaState(NamedTuple):
    ssm: torch.Tensor    # (B, di, ds) float32
    conv: torch.Tensor   # (B, d_conv-1, di) last inputs of the causal conv


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.mamba_expand * cfg.d_model
    dtr = s.mamba_dt_rank or cfg.d_model // 16
    return di, s.mamba_d_state, s.mamba_d_conv, dtr


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> MambaState:
    di, ds, dc, _ = _dims(cfg)
    return MambaState(
        torch.zeros((batch, di, ds), dtype=torch.float32, device=device),
        torch.zeros((batch, dc - 1, di), dtype=dtype, device=device))


class Mamba(nn.Module):
    """``in_proj`` (d, 2di), ``conv_w`` (dc, di) trunc-normal 0.5,
    ``conv_b``, ``x_proj`` (di, dtr + 2ds), ``dt_proj`` (dtr, di),
    ``dt_bias`` -4.6 (softplus^-1 of 0.01), ``A_log`` = log(1..ds) and
    ``D`` = 1 in float32 whatever the param dtype, ``out_proj`` (di, d)."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype()
        di, ds, dc, dtr = _dims(cfg)
        self.in_proj = Linear(d, 2 * di, dt, device, generator=generator)
        self.conv_w = _param(
            trunc_normal((dc, di), 0.5, dt, generator, device)
            if generator is not None
            else torch.zeros((dc, di), dtype=dt, device=device))
        self.conv_b = _param(torch.zeros(di, dtype=dt, device=device))
        self.x_proj = Linear(di, dtr + 2 * ds, dt, device,
                             generator=generator)
        self.dt_proj = Linear(dtr, di, dt, device, generator=generator)
        self.dt_bias = _param(torch.full((di,), -4.6, dtype=dt,
                                         device=device))
        A = torch.arange(1, ds + 1, dtype=torch.float32,
                         device=device).expand(di, ds)
        self.A_log = _param(torch.log(A).contiguous())
        self.D = _param(torch.ones(di, dtype=torch.float32, device=device))
        self.out_proj = Linear(di, d, dt, device, generator=generator)


def _ssm_inputs(p: Mamba, cfg: ModelConfig, xc, w=None):
    """xc: (B,T,di) post-conv activations -> dt (softplus in float32 of
    the projection plus ``dt_bias``), B and C in float32. ``w``: the
    weights (x_proj, dt_proj, dt_bias) where not ``p``'s own."""
    _, ds, _, dtr = _dims(cfg)
    x_proj, dt_proj, dt_bias = w or (p.x_proj.w, p.dt_proj.w, p.dt_bias)
    bcd = xc @ x_proj.to(xc.dtype)
    dt_in, Bm, Cm = torch.split(bcd, [dtr, ds, ds], dim=-1)
    dt = F.softplus((dt_in @ dt_proj.to(xc.dtype)).float() + dt_bias.float())
    return dt, Bm.float(), Cm.float()


def _inclusive_scan(a, b):
    """Inclusive scan over axis 1 of the reference's ``combine`` (earlier,
    later) -> (a1 a2, b1 a2 + b2), in log2(ck) doubling steps."""
    ck = a.shape[1]
    off = 1
    while off < ck:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return a, b


def _scan_group(dt, Bm, Cm, x, A, h, g: int, ck: int):
    """g chunks of ck tokens of the selective scan: dt, x (B, g ck, di);
    Bm, Cm (B, g ck, ds); h (B,di,ds) the state before them. Their
    transition tensors a, b (B g, ck, di, ds) built and scanned at once,
    then h carried from chunk to chunk -> (y (B, g ck, di) float32, h)."""
    B, _, di = x.shape
    ds = A.shape[-1]

    def chunks(t):                                  # (B,g ck,n) -> (B g,ck,n)
        return t.reshape(B * g, ck, t.shape[-1])
    dt_c, B_c = chunks(dt), chunks(Bm)
    a_c = torch.exp(dt_c[..., None] * A[None, None])           # (Bg,ck,di,ds)
    b_c = (dt_c * chunks(x).float())[..., None] * B_c[:, :, None, :]
    aa, bb = _inclusive_scan(a_c, b_c)
    del a_c, b_c
    aa, bb = (t.reshape(B, g, ck, di, ds) for t in (aa, bb))
    ys = []
    for i in range(g):
        h_all = aa[:, i] * h[:, None] + bb[:, i]               # (B,ck,di,ds)
        ys.append(torch.einsum("btds,bts->btd", h_all,
                               Cm[:, i * ck:(i + 1) * ck]))
        h = h_all[:, -1]
        del h_all
    return torch.cat(ys, dim=1), h


def _chunked_ssm_scan(dt, Bm, Cm, x, A, h0):
    """Selective scan, chunked. dt, x: (B,T,di); Bm, Cm: (B,T,ds); A:
    (di,ds); h0: (B,di,ds) float32. -> (y (B,T,di) float32, h (B,di,ds)).

    ``MAMBA_CHUNK``-token chunks when T is a multiple of it, else one chunk
    of T; the transition tensors a, b (B,ck,di,ds) are built and scanned
    for as many chunks at a time as fit ``MAMBA_GROUP_BYTES`` (one at a
    time at a full model's widths, ``_scan_group``), and h is carried from
    chunk to chunk. Every product is elementwise or the chunk's own, so
    the grouping changes no result. Under autograd each group is
    recomputed in the backward (``torch.utils.checkpoint``): its doubling
    steps' products, ~1 GB a 128-token chunk at jamba's width, are then
    held for one group at a time, not for every chunk of the layer."""
    B, T, di = x.shape
    ds = A.shape[-1]
    nchunk = (T // MAMBA_CHUNK if T % MAMBA_CHUNK == 0 and T >= MAMBA_CHUNK
              else 1)
    ck = T // nchunk
    group = max(1, min(nchunk, MAMBA_GROUP_BYTES // (B * ck * di * ds * 4)))
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (dt, Bm, Cm, x, A, h0))
    h, ys = h0, []
    for c0 in range(0, nchunk, group):
        g = min(group, nchunk - c0)
        s = slice(c0 * ck, (c0 + g) * ck)
        args = (dt[:, s], Bm[:, s], Cm[:, s], x[:, s], A, h, g, ck)
        y, h = (checkpoint(_scan_group, *args, use_reentrant=False) if grad
                else _scan_group(*args))
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _ssm_step(dt, Bm, Cm, x, A, h0):
    """One recurrence step. dt, x: (B,di); Bm, Cm: (B,ds); h0: (B,di,ds)
    float32. -> (y (B,di) float32, h (B,di,ds))."""
    a = torch.exp(dt[..., None] * A[None])                     # (B,di,ds)
    b = (dt * x.float())[..., None] * Bm[:, None, :]
    h = a * h0 + b
    return torch.einsum("bds,bs->bd", h, Cm), h


def _lane_lengths(n_real, B: int, device):
    """``n_real`` as the conv and mask read it: None, a host int (the
    scalar form), or a per-lane (B,) int64 tensor on ``device`` (a host
    array or a tensor of more than one element)."""
    if n_real is None:
        return None
    if isinstance(n_real, torch.Tensor):
        if n_real.dim() == 0:
            return int(n_real)
        return n_real.to(device=device, dtype=torch.int64).reshape(B)
    nr = np.asarray(n_real, np.int64)
    if nr.ndim == 0:
        return int(nr)
    return torch.as_tensor(nr.reshape(B)).to(device)


def _causal_conv(p: Mamba, x, conv_prev, n_real=None, w=None):
    """Depthwise causal conv over time. x: (B,T,di); conv_prev:
    (B,dc-1,di). The dc taps are summed in the compute dtype from tap 0,
    then ``conv_b`` is added (the reference's rounding order).

    ``n_real`` (None = T, a host int, or a per-lane (B,) vector) marks the
    last REAL row of a bucket-padded chunk: the returned conv tail is the
    window of the last ``dc-1`` inputs ending at that row. Row ``j`` of the
    padded input holds input ``j-(dc-1)``, so the tail of ``n_real`` real
    tokens starts at row ``n_real``; the vector form gathers each lane's
    window. ``w``: the taps and bias (conv_w, conv_b) where not ``p``'s
    own (a rank's channels). -> (out (B,T,di), tail (B,dc-1,di))"""
    conv_w, conv_b = w or (p.conv_w, p.conv_b)
    dc = conv_w.shape[0]
    B, T, _ = x.shape
    xp = torch.cat([conv_prev.to(x.dtype), x], dim=1)          # (B,T+dc-1,di)
    w = conv_w.to(x.dtype)
    out = xp[:, 0:T] * w[0][None, None]
    for i in range(1, dc):
        out = out + xp[:, i:i + T] * w[i][None, None]
    nr = _lane_lengths(n_real, B, x.device)
    if isinstance(nr, torch.Tensor):
        idx = nr[:, None] + torch.arange(dc - 1, device=x.device)[None, :]
        tail = xp[torch.arange(B, device=x.device)[:, None], idx]
    else:
        start = T if nr is None else min(max(nr, 0), T)
        tail = xp[:, start:start + dc - 1]
    return out + conv_b.to(x.dtype), tail


def mamba_forward(p: Mamba, cfg: ModelConfig, x, state: MambaState,
                  n_real=None) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence forward. x: (B,T,d) -> (out (B,T,d), state').

    ``n_real`` (a host int, or a per-lane (B,) vector in the fused packed
    step) supports bucket-padded chunks: rows ``>= n_real`` get ``dt = 0``,
    an identity transition (``a = 1``, ``b = 0``), so the carried state is
    the state after the last real token and the conv tail ends at it."""
    B, T, _ = x.shape
    xz = linear(p.in_proj, x)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_tail = _causal_conv(p, x_in, state.conv, n_real=n_real)
    xc = F.silu(xc)
    dt, Bm, Cm = _ssm_inputs(p, cfg, xc)
    nr = _lane_lengths(n_real, B, x.device)
    if nr is not None:
        nr = (nr.reshape(-1, 1) if isinstance(nr, torch.Tensor)
              else torch.full((1, 1), nr, device=x.device))
        mask = torch.arange(T, device=x.device)[None, :] < nr
        dt = dt * mask[:, :, None]
    A = -torch.exp(p.A_log.float())
    y, h = _chunked_ssm_scan(dt, Bm, Cm, xc, A, state.ssm.float())
    y = (y + p.D.float()[None, None] * xc.float()).to(x.dtype)
    out = linear(p.out_proj, y * F.silu(z))
    return out, MambaState(h, conv_tail.to(state.conv.dtype))


def mamba_decode(p: Mamba, cfg: ModelConfig, x, state: MambaState
                 ) -> Tuple[torch.Tensor, MambaState]:
    """Single-token step. x: (B,1,d) -> (out (B,1,d), state')."""
    xz = linear(p.in_proj, x)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_tail = _causal_conv(p, x_in, state.conv)
    xc = F.silu(xc)
    dt, Bm, Cm = _ssm_inputs(p, cfg, xc)
    A = -torch.exp(p.A_log.float())
    y, h = _ssm_step(dt[:, 0], Bm[:, 0], Cm[:, 0], xc[:, 0], A,
                     state.ssm.float())
    y = (y[:, None] + p.D.float()[None, None] * xc.float()).to(x.dtype)
    out = linear(p.out_proj, y * F.silu(z))
    return out, MambaState(h, conv_tail.to(state.conv.dtype))


def mamba_sharded(p: Mamba, cfg: ModelConfig, x, state: MambaState,
                  specs: MambaState, rank, *, decode: bool = False,
                  scatter: Optional[int] = None
                  ) -> Tuple[torch.Tensor, MambaState]:
    """``mamba_forward`` (``mamba_decode`` with ``decode``) on a rank: x
    (B,T,d) replicated over ``model``; ``state`` the rank's blocks of the
    cache under ``specs`` (without the group entry): conv channels
    [c0, c1), the ssm state's channels [i0, i1) and states [s0, s1).

    ``in_proj``'s columns (the rules split [x_in | z] over ``model``, so a
    rank holds only x_in's or only z's) are all-gathered whole; the conv
    runs on the rank's channels against its conv state, and its output is
    all-gathered whole; x_proj, dt_proj and A_log are gathered whole (they
    are small); the scan runs on the rank's block of the ssm state over
    its channels and states, and the partial C.h, placed at its channels,
    is all-reduced over ``model``; then D, the gate and the rank's rows of
    ``out_proj``, all-reduced (reduce-scattered along ``scatter``: the
    train step's sequence parallelism).

    In training (``mamba_train_sharded``) x enters the rank's work: every
    product above feeds only the rank's own channels, states and
    ``out_proj`` rows, so each gradient it holds is its share, and the
    all-reduced C.h, consumed by its own rows alone, enters them."""
    B, T, _ = x.shape
    di = _dims(cfg)[0]
    x_in, z = torch.chunk(linear_gathered([(p.in_proj, x)], rank)[0], 2,
                          dim=-1)
    conv = own_slices(state.conv, specs.conv, rank, (2,))[2]
    xc, conv_tail = _causal_conv(
        p, x_in[..., conv], state.conv,
        w=(whole(p, "conv_w", rank)[:, conv], whole(p, "conv_b", rank)[conv]))
    xc = F.silu(xc)
    if splits(specs.conv):
        xc = rank.all_gather(xc, -1, "model")
    dt, Bm, Cm = _ssm_inputs(p, cfg, xc, w=tuple(
        whole(m, n, rank) for m, n in ((p.x_proj, "w"), (p.dt_proj, "w"),
                                       (p, "dt_bias"))))
    chans, sts = own_slices(state.ssm, specs.ssm, rank, (1, 2))[1:]
    A = -torch.exp(whole(p, "A_log", rank).float())[chans, sts]
    args = (dt[..., chans], Bm[..., sts], Cm[..., sts], xc[..., chans], A,
            state.ssm.float())
    if decode:
        y, h = _ssm_step(*(t[:, 0] for t in args[:4]), *args[4:])
        y = y[:, None]
    else:
        y, h = _chunked_ssm_scan(*args)
    if splits(specs.ssm):
        if y.shape[-1] != di:
            y = torch.zeros((B, T, di), dtype=y.dtype,
                            device=y.device).index_copy_(
                2, torch.arange(chans.start, chans.stop, device=y.device), y)
        y = rank.enter(rank.all_reduce(y, "model"))
    y = (y + whole(p, "D", rank).float()[None, None] * xc.float()).to(x.dtype)
    out = linear_rows(p.out_proj, y * F.silu(z), 0, di, rank, scatter)
    return out, MambaState(h, conv_tail.to(state.conv.dtype))


def mamba_train_sharded(p: Mamba, cfg: ModelConfig, x, shard_axes, *,
                        sp: bool) -> torch.Tensor:
    """The training forward's Mamba on a rank (the reference's
    ``mamba_forward`` under ``shard_axes``, whose ``xz`` it constrains to
    ``model``): ``mamba_sharded`` at every position from a zero state,
    split over ``model`` as the mesh's ``ShardingRules`` split the decode
    cache's (``partition.shard_state``). x (B,T,d), the rank's block of the
    positions (B, T / model, d) under sequence parallelism (``sp``),
    all-gathered along T, else the stream, replicated over ``model``,
    entering the rank's work; ``out_proj``'s partial sums all-reduced, or
    reduce-scattered along T under ``sp``."""
    rank = shard_axes["ctx"]
    x = rank.all_gather(x, 1, "model") if sp else rank.enter(x)
    state, specs = shard_state(
        init_mamba_state(cfg, x.shape[0], x.dtype, x.device),
        ShardingRules(shard_axes["mesh"], cfg), rank)
    return mamba_sharded(p, cfg, x, state, specs, rank,
                         scatter=1 if sp else None)[0]
