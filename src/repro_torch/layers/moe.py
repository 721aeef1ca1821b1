"""Token-choice top-k MoE with DeepSeek's shared experts —
``repro/layers/moe.py`` for the paged serving path (dropless routing).

The reference's dropless dispatch sets the capacity to the token count and
runs every expert over an (E, N, d) buffer that is almost all zeros. Here
the same function is computed grouped by expert: the N x K assignments are
sorted by expert and each expert that received any runs its rows through
its FFN, one GEMM per projection. The per-expert counts reach the host
once per MoE layer (they size the loop): one host sync per layer.
Routing, the gate's rounding to the compute dtype and the sum over the K
assignments in the compute dtype follow the reference's rounding points.

Not ported: capacity dispatch (``dropless=False``: training and the
non-paged prefill) and expert parallelism (``shard_axes``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.core import (MLP, Linear, _act, _param, mlp,
                                     trunc_normal)


def expert_ff(cfg: ModelConfig) -> int:
    return cfg.moe.d_ff_expert or cfg.d_ff


class MoE(nn.Module):
    """``router`` (d, E); routed experts ``up`` / ``gate`` (E, d, fe) and
    ``down`` (E, fe, d); ``shared``, the always-on experts as one MLP of
    width ``fe x n_shared_experts`` (absent when there are none)."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = cfg.moe
        d, fe, dt = cfg.d_model, expert_ff(cfg), cfg.dtype()

        def experts(shape, std):
            return _param(trunc_normal(shape, std, dt, generator, device)
                          if generator is not None
                          else torch.zeros(shape, dtype=dt, device=device))
        std_in, std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(fe)
        self.router = Linear(d, m.n_experts, dt, device, generator=generator)
        self.up = experts((m.n_experts, d, fe), std_in)
        self.down = experts((m.n_experts, fe, d), std_out)
        self.gate = (experts((m.n_experts, d, fe), std_in)
                     if cfg.activation in ("swiglu", "geglu") else None)
        self.shared = (MLP(cfg, device, generator,
                           d_ff=fe * m.n_shared_experts)
                       if m.n_shared_experts else None)


def route(p: MoE, cfg: ModelConfig, xt: torch.Tensor):
    """The reference's ``_route`` in float32: softmax over the router
    logits, top-k, gates renormalised (sum clipped at 1e-9) and the Switch
    aux loss. xt: (N, d) -> (gates (N,K) f32, experts (N,K) int64, aux)."""
    m = cfg.moe
    N, E, K = xt.shape[0], m.n_experts, m.top_k
    probs = torch.softmax(xt.float() @ p.router.w.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    ce = expert_counts(expert_idx, E).float() / (N * K)
    aux = E * torch.sum(probs.mean(dim=0) * ce)
    return gate_vals, expert_idx, aux


def expert_counts(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments per expert, on the device without a host sync (CUDA's
    ``bincount`` reads the input's range back to size its output)."""
    flat = expert_idx.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))


def _routed_experts(p: MoE, cfg: ModelConfig, xt, gate_vals, expert_idx):
    """sum_k gate_k x FFN_{e_k}(x) over every assignment (dropless),
    grouped by expert. The per-expert counts come to the host here: one
    sync per call."""
    N, K = expert_idx.shape
    dt = xt.dtype
    flat = expert_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = expert_counts(flat, cfg.moe.n_experts).tolist()   # host sync
    xs = xt[order // K]                       # assignments, by expert
    ys = torch.empty_like(xs)
    start = 0
    for e, c in enumerate(counts):
        if not c:
            continue
        rows = xs[start:start + c]
        up = rows @ p.up[e].to(dt)
        h = (_act(cfg.activation, rows @ p.gate[e].to(dt)) * up
             if p.gate is not None else _act(cfg.activation, up))
        torch.matmul(h, p.down[e].to(dt), out=ys[start:start + c])
        start += c
    y_asn = torch.empty_like(ys).index_copy_(0, order, ys)
    w = gate_vals.reshape(N * K).to(dt)
    return (y_asn * w[:, None]).reshape(N, K, -1).sum(dim=1)


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
              dropless: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out (B, T, d), aux loss f32). Dropless: every
    token's K assignments are kept, so a token's output does not depend on
    the other tokens of the call (pads included)."""
    if not dropless:
        raise NotImplementedError(
            "moe_apply: capacity dispatch (dropless=False) is not ported "
            "(ROADMAP queue 1, item 8)")
    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    gate_vals, expert_idx, aux = route(p, cfg, xt)
    y = _routed_experts(p, cfg, xt, gate_vals, expert_idx)
    if p.shared is not None:
        y = y + mlp(p.shared, cfg, xt)
    return y.reshape(B, T, d), aux.float()
