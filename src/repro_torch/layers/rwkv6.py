"""RWKV-6 "Finch" layers: time-mix with data-dependent decay + channel-mix —
a port of ``repro/layers/rwkv6.py`` under the same parameter names.

Recurrence (per head, head_dim hd, state S in R^{hd x hd}):
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T          (w_t = -exp(...) < 0)

``impl="kernel"`` sends the recurrence through ``kernels/rwkv6_wkv/ops.wkv6``
(the CUDA kernel on a CUDA device, its plain version on the CPU);
``impl="ref"`` calls the plain version ``wkv6_plain`` directly, which keeps
the reference's dispatch (chunked for ``T >= 64`` and ``T % 32 == 0``, the
sequential scan otherwise).

On a rank of a mesh (``rwkv_block_sharded``) the rules split the wkv
state's key dim over ``model``: the rank runs the recurrence on its key
rows of every head (``wkv6`` takes that rectangular state to the
key-slice kernel) and the shares of y are all-reduced. The partitioned
train step (``rwkv_train_sharded``) runs the same block from a zero state
under autograd: the key-slice kernel's backward, the collectives'
(``distributed/partition.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_plain
from repro_torch.distributed.partition import own_slices, shard_state, splits
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.layers.core import (Linear, _param, check_impl, linear,
                                     linear_cols, linear_gathered,
                                     linear_rows, rms_norm, trunc_normal,
                                     whole)


class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, hd, hd) float32
    tm_shift: torch.Tensor  # (B, d)  previous token (time-mix)
    cm_shift: torch.Tensor  # (B, d)  previous token (channel-mix)


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device=None) -> RWKVState:
    hd = cfg.ssm.rwkv_head_dim
    H = cfg.d_model // hd
    return RWKVState(
        torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))


class TimeMix(nn.Module):
    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, s, dt = cfg.d_model, cfg.ssm, cfg.dtype()
        hd = s.rwkv_head_dim
        H = d // hd

        def tn(shape):
            return _param(trunc_normal(shape, 0.02, dt, generator, device)
                          if generator is not None
                          else torch.zeros(shape, dtype=dt, device=device))
        self.mu_x = _param(torch.zeros(d, dtype=dt, device=device))
        self.maa = _param(torch.zeros((5, d), dtype=dt, device=device))
        self.mix_w1 = tn((d, 5 * s.rwkv_lora_mix))
        self.mix_w2 = tn((5, s.rwkv_lora_mix, d))
        self.w0 = _param(torch.full((d,), -6.0, dtype=dt, device=device))
        self.decay_w1 = tn((d, s.rwkv_lora_decay))
        self.decay_w2 = tn((s.rwkv_lora_decay, d))
        self.u = tn((H, hd))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, Linear(d, d, dt, device, generator=generator))
        self.ln_x = _param(torch.zeros(d, dtype=dt, device=device))


class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype()
        self.mu_k = _param(torch.zeros(d, dtype=dt, device=device))
        self.mu_r = _param(torch.zeros(d, dtype=dt, device=device))
        self.wk = Linear(d, f, dt, device, generator=generator)
        self.wv = Linear(f, d, dt, device, generator=generator)
        self.wr = Linear(d, d, dt, device, generator=generator)


class RWKV(nn.Module):
    """The sequence mixer of an RWKV sub-layer: ``tm`` and ``cm``."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tm = TimeMix(cfg, device, generator)
        self.cm = ChannelMix(cfg, device, generator)


def _head_norm(scale, y, H: int, hd: int, eps: float = 1e-5):
    B, T = y.shape[:2]
    yh = y.reshape(B, T, H, hd).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return (yh.reshape(B, T, H * hd) * (1.0 + scale.float())).to(y.dtype)


def _tm_inputs(x, xx, mu_x, maa, mix_w1, mix_w2):
    """Data-dependent token-shift interpolation for (w,k,v,r,g)."""
    x_mix = x + xx * mu_x.to(x.dtype)
    B, T, _ = x.shape
    mr = mix_w1.shape[1] // 5
    mix = torch.tanh(x_mix @ mix_w1.to(x.dtype)).reshape(B, T, 5, mr)
    lora = torch.einsum("btfr,frd->btfd", mix, mix_w2.to(x.dtype))
    interp = maa.to(x.dtype)[None, None] + lora                # (B,T,5,d)
    return [x + xx * interp[:, :, i] for i in range(5)]


def _log_decay(xw, w0, decay_w1, decay_w2):
    """The data-dependent log-decay -exp(w0 + LoRA(xw)), float32."""
    return -torch.exp(w0.float()
                      + (torch.tanh(xw @ decay_w1.to(xw.dtype))
                         @ decay_w2.to(xw.dtype)).float())


def _shifted(x, shift_prev):
    """The previous token's row of every row of x (B,T,d): ``shift_prev``
    (B,d) before the first."""
    return torch.cat([shift_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _lane_lengths(n_real, B: int, device) -> Optional[torch.Tensor]:
    """``n_real`` (None, a host int, a per-lane (B,) host array, or such a
    tensor) as a (B,) int64 tensor on ``device``; None stays None."""
    if n_real is None:
        return None
    if isinstance(n_real, torch.Tensor):
        return n_real.to(device=device, dtype=torch.int64).expand(B)
    nr = np.asarray(n_real, np.int64).reshape(-1)
    if nr.size == 1:
        nr = np.full((B,), int(nr[0]), np.int64)
    return torch.as_tensor(nr).to(device)


def _last_real_row(x, nr: Optional[torch.Tensor]):
    """Row ``n_real - 1`` of each lane of (B,T,d) — the shift state a
    bucket-padded chunk must carry (``x[:, -1]`` when ``nr`` is None)."""
    if nr is None:
        return x[:, -1]
    idx = torch.clamp(nr - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def rwkv_time_mix(p: TimeMix, cfg: ModelConfig, x, shift_prev, wkv_state, *,
                  impl: str = "kernel", n_real=None):
    """x: (B,T,d); shift_prev: (B,d) the last token's hidden state of the
    previous chunk; wkv_state: (B,H,hd,hd) float32.

    ``n_real`` (a host int, or a per-lane (B,) host array in the fused
    step) marks each lane's last real row of a bucket-padded chunk: padded
    rows get ``w = 0`` (decay 1) and ``k = 0`` (no update), so the carried
    state after the chunk is the state after the last real token, and the
    returned shift state is that token's row.
    -> (out (B,T,d), tm_shift (B,d), wkv_state')
    """
    check_impl(impl)
    B, T, d = x.shape
    hd = cfg.ssm.rwkv_head_dim
    H = d // hd
    nr = _lane_lengths(n_real, B, x.device)
    xx = _shifted(x, shift_prev) - x
    xw, xk, xv, xr, xg = _tm_inputs(x, xx, p.mu_x, p.maa, p.mix_w1,
                                    p.mix_w2)
    logw = _log_decay(xw, p.w0, p.decay_w1, p.decay_w2)
    r = linear(p.wr, xr).reshape(B, T, H, hd)
    k = linear(p.wk, xk).reshape(B, T, H, hd)
    v = linear(p.wv, xv).reshape(B, T, H, hd)
    g = F.silu(linear(p.wg, xg))
    w = logw.reshape(B, T, H, hd)
    if nr is not None:
        m = (torch.arange(T, device=x.device)[None, :]
             < nr[:, None])[:, :, None, None]
        k = k * m
        w = w * m
    u = p.u.float()
    if impl == "kernel":
        y, wkv_state = wkv_ops.wkv6(r.contiguous(), k.contiguous(),
                                    v.contiguous(), w.contiguous(),
                                    u.contiguous(), wkv_state.contiguous())
    else:
        y, wkv_state = wkv6_plain(r, k, v, w, u, wkv_state)
    y = _head_norm(p.ln_x, y.reshape(B, T, d), H, hd)
    out = linear(p.wo, y * g)
    return out, _last_real_row(x, nr), wkv_state


def rwkv_channel_mix(p: ChannelMix, x, shift_prev, n_real=None):
    """-> (out (B,T,d), cm_shift (B,d))."""
    xx = _shifted(x, shift_prev) - x
    xk = x + xx * p.mu_k.to(x.dtype)
    xr = x + xx * p.mu_r.to(x.dtype)
    k = torch.square(F.relu(linear(p.wk, xk)))
    out = torch.sigmoid(linear(p.wr, xr)) * linear(p.wv, k)
    return out, _last_real_row(x, _lane_lengths(n_real, x.shape[0],
                                                x.device))


def rwkv_block(p: RWKV, cfg: ModelConfig, x, state: RWKVState, norms: dict,
               *, impl: str = "kernel", n_real=None
               ) -> Tuple[torch.Tensor, RWKVState]:
    """One RWKV sub-layer with its own residuals: pre-norm time-mix, then
    pre-norm channel-mix. ``norms``: {"n1", "n2"} RMSNorm modules."""
    n_real = _lane_lengths(n_real, x.shape[0], x.device)
    h, tm_shift, wkv = rwkv_time_mix(
        p.tm, cfg, rms_norm(norms["n1"], x, cfg.rmsnorm_eps),
        state.tm_shift, state.wkv, impl=impl, n_real=n_real)
    x = x + h
    h, cm_shift = rwkv_channel_mix(
        p.cm, rms_norm(norms["n2"], x, cfg.rmsnorm_eps), state.cm_shift,
        n_real=n_real)
    x = x + h
    return x, RWKVState(wkv, tm_shift.to(state.tm_shift.dtype),
                        cm_shift.to(state.cm_shift.dtype))


# ---------------------------------------------------------------------------
# The partitioned step (a rank's shards; ``distributed/partition.py``)
# ---------------------------------------------------------------------------
def rwkv_time_mix_sharded(p: TimeMix, cfg: ModelConfig, x, shift_prev,
                          wkv_state, specs: RWKVState, rank, *,
                          impl: str = "kernel"):
    """``rwkv_time_mix`` on a rank: x (B,T,d) replicated over ``model``;
    ``shift_prev`` and ``wkv_state`` the rank's blocks of the cache under
    ``specs`` (the leaves' specs without the group entry): its channels of
    the shift state, its heads and key rows of the wkv state (the rules
    split the state's key dim where the heads do not divide the axis).

    The small weights (the token-shift LoRA, the decay LoRA, ``u``,
    ``ln_x``) are gathered whole; r, k and v are projected on the rank's
    columns and all-gathered in one collective, w computed whole; the
    rank runs the recurrence on its heads and key rows (``wkv6`` takes a
    rectangular state to the key-slice kernel), its exact share of y is
    all-reduced over ``model``, the head norm applied to the whole y, then
    g on the rank's columns and its rows of ``wo``, all-reduced.

    Under autograd (the train step) the work after x is the rank's own:
    x enters it, and so does the all-reduced y, whose head norm feeds only
    the rank's columns (``distributed/partition.py``'s convention); the
    small weights enter through ``whole``; v's partial gradients (a key
    slice's share) are summed over ``model`` by its all-gather's backward.
    -> (out (B,T,d), the rank's tm_shift block, its wkv state)"""
    check_impl(impl)
    x = rank.enter(x)
    B, T, d = x.shape
    hd = cfg.ssm.rwkv_head_dim
    H = d // hd
    xx = _shifted(x, rank.gather(shift_prev, specs.tm_shift, ("model",))) - x
    xw, xk, xv, xr, xg = _tm_inputs(
        x, xx, *(whole(p, n, rank) for n in ("mu_x", "maa", "mix_w1",
                                             "mix_w2")))
    w = _log_decay(xw, *(whole(p, n, rank) for n in (
        "w0", "decay_w1", "decay_w2"))).reshape(B, T, H, hd)
    r, k, v = (t.reshape(B, T, H, hd) for t in linear_gathered(
        [(p.wr, xr), (p.wk, xk), (p.wv, xv)], rank))
    g, glo, ghi = linear_cols(p.wg, xg, rank)
    heads, keys = own_slices(wkv_state, specs.wkv, rank, (1, 2))[1:3]
    u = whole(p, "u", rank).float()[heads, keys]

    def own(t):
        return t[:, :, heads, keys].contiguous()
    attend = wkv_ops.wkv6 if impl == "kernel" else wkv6_plain
    y, wkv_state = attend(own(r), own(k), v[:, :, heads].contiguous(),
                          own(w), u.contiguous(), wkv_state.contiguous())
    if splits(specs.wkv):
        if y.shape[2] != H:
            y = torch.zeros((B, T, H, hd), dtype=y.dtype,
                            device=y.device).index_copy(
                2, torch.arange(heads.start, heads.stop, device=y.device), y)
        y = rank.enter(rank.all_reduce(y, "model"))
    y = _head_norm(whole(p, "ln_x", rank), y.reshape(B, T, d), H, hd)
    out = linear_rows(p.wo, y[..., glo:ghi] * F.silu(g), glo, ghi, rank)
    tm = x[:, -1][own_slices(shift_prev, specs.tm_shift, rank, (1,))]
    return out, tm, wkv_state


def rwkv_channel_mix_sharded(p: ChannelMix, x, shift_prev, spec, rank):
    """``rwkv_channel_mix`` on a rank (``shift_prev`` its channels under
    ``spec``): the key projection and, since the rules split ``cm.wv``'s
    output, r and the value projection on the rank's columns, each
    all-gathered whole. Under autograd x enters the rank's work; the
    gathered r and value product feed the output every rank computes
    alike, so their gather's backward keeps the rank's block of the
    gradient (``alike``). -> (out (B,T,d), the rank's cm_shift block)"""
    x = rank.enter(x)
    xx = _shifted(x, rank.gather(shift_prev, spec, ("model",))) - x
    xk = x + xx * whole(p, "mu_k", rank).to(x.dtype)
    xr = x + xx * whole(p, "mu_r", rank).to(x.dtype)
    k = torch.square(F.relu(linear_gathered([(p.wk, xk)], rank)[0]))
    r, kv = linear_gathered([(p.wr, xr), (p.wv, k)], rank, alike=True)
    return (torch.sigmoid(r) * kv,
            x[:, -1][own_slices(shift_prev, spec, rank, (1,))])


def rwkv_block_sharded(p: RWKV, cfg: ModelConfig, x, state: RWKVState,
                       norms: dict, specs: RWKVState, rank, *,
                       impl: str = "kernel") -> Tuple[torch.Tensor, RWKVState]:
    """``rwkv_block`` on a rank: ``state`` its blocks under ``specs``."""
    h, tm_shift, wkv = rwkv_time_mix_sharded(
        p.tm, cfg, rms_norm(norms["n1"], x, cfg.rmsnorm_eps),
        state.tm_shift, state.wkv, specs, rank, impl=impl)
    x = x + h
    h, cm_shift = rwkv_channel_mix_sharded(
        p.cm, rms_norm(norms["n2"], x, cfg.rmsnorm_eps), state.cm_shift,
        specs.cm_shift, rank)
    x = x + h
    return x, RWKVState(wkv, tm_shift.to(state.tm_shift.dtype),
                        cm_shift.to(state.cm_shift.dtype))


def rwkv_train_sharded(p: RWKV, cfg: ModelConfig, x, norms: dict,
                       shard_axes, *, sp: bool,
                       impl: str = "kernel") -> torch.Tensor:
    """An RWKV sub-layer of the training forward on a rank (the
    reference's ``rwkv_block`` from a zero state, which its ``_group_train``
    runs between ``_sp_constrain``s): ``rwkv_block_sharded`` from a zero
    state split over ``model`` as the mesh's ``ShardingRules`` split the
    decode cache's (``partition.shard_state``: the wkv state by key rows,
    or heads, the shift states by channels). x (B,T,d) is the stream,
    replicated over ``model``, or under sequence parallelism (``sp``) the
    rank's block of the positions (B, T / model, d): then all-gathered
    along T into the stream every rank runs alike (its gradient the
    rank's block of the whole) and split back after the block.
    -> x after the sub-layer, in the layout it came in."""
    rank = shard_axes["ctx"]
    if sp:
        x = rank.all_gather(x, 1, "model", alike=True)
    state, specs = shard_state(
        init_rwkv_state(cfg, x.shape[0], x.dtype, x.device),
        ShardingRules(shard_axes["mesh"], cfg), rank)
    x, _ = rwkv_block_sharded(p, cfg, x, state, norms, specs, rank,
                              impl=impl)
    return rank.split(x, 1, "model") if sp else x
