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
from repro_torch.layers.core import (Linear, _param, check_impl, linear,
                                     rms_norm, trunc_normal)


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


def _tm_inputs(p: TimeMix, x, xx):
    """Data-dependent token-shift interpolation for (w,k,v,r,g)."""
    x_mix = x + xx * p.mu_x.to(x.dtype)
    B, T, _ = x.shape
    mr = p.mix_w1.shape[1] // 5
    mix = torch.tanh(x_mix @ p.mix_w1.to(x.dtype)).reshape(B, T, 5, mr)
    lora = torch.einsum("btfr,frd->btfd", mix, p.mix_w2.to(x.dtype))
    interp = p.maa.to(x.dtype)[None, None] + lora              # (B,T,5,d)
    return [x + xx * interp[:, :, i] for i in range(5)]


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
    prev = torch.cat([shift_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    xx = prev - x
    xw, xk, xv, xr, xg = _tm_inputs(p, x, xx)

    logw = -torch.exp(p.w0.float()
                      + (torch.tanh(xw @ p.decay_w1.to(x.dtype))
                         @ p.decay_w2.to(x.dtype)).float())
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
    prev = torch.cat([shift_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    xx = prev - x
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
