"""Token-choice top-k MoE with DeepSeek's shared experts —
``repro/layers/moe.py`` for the paged serving path (dropless routing) and
training (capacity dispatch).

Dropless (serving): the reference sets the capacity to the token count and
runs every expert over an (E, N, d) buffer that is almost all zeros. Here
the same function is computed grouped by expert: the N x K assignments are
sorted by expert and each expert that received any runs its rows through
its FFN, one GEMM per projection. The per-expert counts reach the host
once per MoE layer (they size the loop): one host sync per layer.

Capacity dispatch (training, ``dropless=False``): the reference's GShard
dispatch, each expert taking at most C = ``moe_capacity`` assignments in
token-major order, its experts run as batched (E, C, d) products; C is
known before the call, so it needs no host sync.

Routing, the gate's rounding to the compute dtype and the sum over the K
assignments in the compute dtype follow the reference's rounding points.

Expert parallelism (``shard_axes``, the reference's ``shard_map`` over
``model``, ``repro/layers/moe.py:156-200``): on a rank of a mesh the router
is replicated (gathered), the rank runs its E/TP experts on its own token
rows through the same dispatch, with the capacity from the local token
count (or dropless), and one all-reduce over ``model`` sums the partial
outputs (a reduce-scatter along T under the train step's sequence
parallelism). The same code trains: ``moe_apply``'s docstring gives the
router's gradient.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.partition import pspec
from repro_torch.layers.core import (MLP, Linear, _act, _param, mlp,
                                     trunc_normal, whole)


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


def route(p: MoE, cfg: ModelConfig, xt: torch.Tensor, router_w=None):
    """The reference's ``_route`` in float32: softmax over the router
    logits, top-k, gates renormalised (sum clipped at 1e-9) and the Switch
    aux loss. xt: (N, d) -> (gates (N,K) f32, experts (N,K) int64, aux).
    ``router_w`` stands for ``p.router.w`` (a rank's gathered copy)."""
    m = cfg.moe
    N, E, K = xt.shape[0], m.n_experts, m.top_k
    w = p.router.w if router_w is None else router_w
    probs = torch.softmax(xt.float() @ w.float(), dim=-1)
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


def _routed_experts(cfg: ModelConfig, xt, gate_vals, expert_idx, stacks,
                    e_lo: int = 0):
    """sum_k gate_k x FFN_{e_k}(x) over every assignment (dropless),
    grouped by expert. ``stacks`` (up, gate or None, down) hold experts
    [e_lo, e_lo + El): a rank's own under expert parallelism, whose
    other assignments sort last and add zero. The per-expert counts come
    to the host here: one sync per call. Meta tensors (the dry run's
    trace) have no routing to read: the N K assignments are split evenly
    over the experts, which runs the same rows through the same products
    (each assignment once), so the trace counts the FLOP and bytes any
    routing does."""
    up_w, gate_w, down_w = stacks
    N, K = expert_idx.shape
    dt = xt.dtype
    flat = expert_idx.reshape(-1)
    E, El = cfg.moe.n_experts, up_w.shape[0]
    if El < E:
        local = flat - e_lo
        is_local = (local >= 0) & (local < El)
        flat = torch.where(is_local, local, torch.full_like(local, El))
    order = torch.argsort(flat, stable=True)
    if flat.device.type == "meta":
        n = N * K * El // E
        counts = [n // El + (e < n % El) for e in range(El)]
    else:
        counts = expert_counts(flat, El + (El < E)).tolist()[:El]  # sync
    xs = xt[order // K]                       # assignments, by expert
    ys = torch.empty_like(xs)
    start = 0
    for e, c in enumerate(counts):
        if not c:
            continue
        rows = xs[start:start + c]
        up = rows @ up_w[e].to(dt)
        h = (_act(cfg.activation, rows @ gate_w[e].to(dt)) * up
             if gate_w is not None else _act(cfg.activation, up))
        torch.matmul(h, down_w[e].to(dt), out=ys[start:start + c])
        start += c
    w = gate_vals.reshape(N * K)
    if El < E:
        ys[start:].zero_()
        w = w * is_local
    y_asn = torch.empty_like(ys).index_copy_(0, order, ys)
    w = w.to(dt)
    return (y_asn * w[:, None]).reshape(N, K, -1).sum(dim=1)


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Assignments an expert takes under capacity dispatch: ceil(N K
    capacity_factor / E), at least 8 and rounded up to a multiple of 8 (the
    reference's rounding, kept for its TPU lanes)."""
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, -(-c // 8) * 8)


def capacity_slots(expert_idx: torch.Tensor, n_experts: int, C: int):
    """Each (token, k) assignment's slot in its expert, by a cumsum over
    the (N K, E) one-hot in token-major order, and whether it is kept
    (slot < C). expert_idx: (N, K) -> (pos (N K,) int64, keep (N K,)
    bool), on the device."""
    flat = expert_idx.reshape(-1)
    # (E, N K): the scan runs along the contiguous dim
    onehot = torch.zeros((n_experts, flat.shape[0]), dtype=torch.int32,
                         device=flat.device).scatter_(0, flat[None], 1)
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(before, 0, flat[None])[0].long()
    return pos, pos < C


def _dispatch_ffn(cfg: ModelConfig, xt, gate_vals, expert_idx, stacks,
                  C: int, e_lo: int = 0):
    """The reference's capacity dispatch, expert FFN and combine over the
    experts [e_lo, e_lo + El) of ``stacks`` (its ``_dispatch_ffn`` with
    ``e_lo``): the kept assignments are scattered into an (El C + 1, d)
    buffer (the last row takes the dropped ones and a rank's others, as
    zeros), every expert runs its C rows as batched products (El, C, d) x
    (El, d, f), and each assignment's row is gathered back and weighted by
    gate x keep in the compute dtype. An assignment's slot counts the
    assignments to its expert before it in token-major order, so a rank's
    expert keeps what it keeps on one device at the same C."""
    up_w, gate_w, down_w = stacks
    N, d = xt.shape
    K = expert_idx.shape[1]
    E, El = cfg.moe.n_experts, up_w.shape[0]
    dt = xt.dtype
    pos, keep = capacity_slots(expert_idx, E, C)
    slot = expert_idx.reshape(-1)
    if El < E:
        slot = slot - e_lo
        keep = keep & (slot >= 0) & (slot < El)
    dest = torch.where(keep, slot * C + pos, torch.full_like(pos, El * C))
    xr = xt[:, None].expand(N, K, d).reshape(N * K, d)
    buf = xt.new_zeros((El * C + 1, d)).index_add(
        0, dest, torch.where(keep[:, None], xr, torch.zeros_like(xr)))
    xd = buf[:El * C].reshape(El, C, d)
    up = torch.bmm(xd, up_w.to(dt))
    h = (_act(cfg.activation, torch.bmm(xd, gate_w.to(dt))) * up
         if gate_w is not None else _act(cfg.activation, up))
    y_flat = torch.bmm(h, down_w.to(dt)).reshape(El * C, d)
    y_asn = torch.where(keep[:, None],
                        torch.index_select(y_flat, 0,
                                           dest.clamp(max=El * C - 1)),
                        torch.zeros_like(xr))
    w = (gate_vals.reshape(N * K) * keep).to(dt)
    return (y_asn * w[:, None]).reshape(N, K, d).sum(dim=1)


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
              dropless: bool = True, shard_axes=None, sp: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out (B, T, d), aux loss f32). Dropless (serving):
    every token's K assignments are kept, so a token's output does not
    depend on the other tokens of the call (pads included). Otherwise
    (training, the dense cache's prefill) capacity dispatch at C =
    ``moe_capacity(cfg, B T)``: assignments past an expert's C-th, in
    token-major order, are dropped.

    With ``shard_axes`` (``p`` a rank's shard, x its rows: the whole batch
    where it does not divide the dp axes) expert parallelism, the
    reference's ``shard_map`` over ``model`` (its ``in_specs P(dp, None,
    None)``): the router gathered whole, the rank's experts from ``e_lo =
    model rank x El`` (gathered over ``data`` where FSDP splits them) on
    its rows at every position, C from its token count, one all-reduce
    over ``model``, then the shared experts split as an MLP. With ``sp``
    (the partitioned train step's stream split along T over ``model``) x
    is the rank's block of the positions (B, T / model, d): all-gathered
    along T first, the experts' partial sums reduce-scattered along T.

    In training x enters the rank's work (``enter``, or the all-gather):
    the gate values weight only its own experts' outputs, so the router's
    gradient through them is the rank's share. The aux loss is computed
    alike on every rank of ``model`` from the same rows: its gradient is
    taken on the group's first rank alone (its value on every rank), so
    that the shares sum to it once. The routing counts and slots are
    integers, outside the autograd graph."""
    rank = shard_axes["ctx"] if shard_axes else None
    x_in = x
    if rank is None:
        # the routed and the shared experts each reach x by one edge, as
        # a rank's collectives reach it: their gradients add in the same
        # order, and the partitioned step at world size 1 is this bit for
        # bit
        x = x.view_as(x)
    else:
        x = rank.all_gather(x, 1, "model") if sp else rank.enter(x)
    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    if rank is None:
        gate_vals, expert_idx, aux = route(p, cfg, xt)
        stacks, e_lo = (p.up, p.gate, p.down), 0
    else:
        axis = pspec(p, "up")[0]
        if axis is None and rank.model_n > 1 and torch.is_grad_enabled():
            raise ValueError(f"{cfg.name}: training under expert "
                             "parallelism needs the experts split over "
                             "model")
        gate_vals, expert_idx, aux = route(p, cfg, xt,
                                           whole(p.router, "w", rank))
        if rank.coords["model"]:
            aux = aux.detach()
        stacks = tuple(None if getattr(p, n) is None else
                       rank.gather(getattr(p, n), pspec(p, n))
                       for n in ("up", "gate", "down"))
        e_lo, _ = rank.range(axis, p.up.shape[0])
    if dropless:
        y = _routed_experts(cfg, xt, gate_vals, expert_idx, stacks, e_lo)
    else:
        y = _dispatch_ffn(cfg, xt, gate_vals, expert_idx, stacks,
                          moe_capacity(cfg, B * T), e_lo)
    y = y.reshape(B, T, d)
    if rank is not None and sp:
        y = rank.reduce_scatter(y, 1, axis)
    elif rank is not None and axis is not None:
        y = rank.all_reduce(y, axis)
    if p.shared is not None:
        y = y + (mlp(p.shared, cfg, x_in, rank, sp) if rank is not None
                 else mlp(p.shared, cfg, x_in.view_as(x_in)))
    return y, aux.float()
