"""AdamW and LR schedules — ``repro/training/optimizer.py``.

AdamW with decoupled weight decay, global-norm clipping, and mixed
precision: bf16 params + float32 master copies and moments. Parameters and
state are dicts keyed by parameter name (``dict(model.named_parameters())``)
and are UPDATED IN PLACE: the reference returns new trees; here
``adamw_update`` writes the moments, the master and the params it was given
and returns them for the same call shape. The arithmetic is the
reference's, one plain loop over the parameters. Schedules: linear warmup
-> cosine, and WSD (warmup-stable-decay).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch


class AdamWState(NamedTuple):
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    master: Optional[Dict[str, torch.Tensor]]   # None when params are f32


@dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[int], float] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Dict[str, torch.Tensor], cfg: AdamWConfig
               ) -> AdamWState:
    zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
    needs_master = any(p.dtype != torch.float32 for p in params.values())
    master = ({n: p.detach().float().clone() for n, p in params.items()}
              if needs_master else None)
    return AdamWState(0, zeros(), zeros(), master)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tensors))


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Dict[str, torch.Tensor], cfg: AdamWConfig
                 ) -> Tuple[Dict[str, torch.Tensor], AdamWState, dict]:
    step = state.step + 1
    gnorm = global_norm(grads[n] for n in params)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    c1 = 1 - cfg.b1 ** step
    c2 = 1 - cfg.b2 ** step
    for n, p in params.items():
        g = grads[n].float() * scale
        m, v = state.mu[n], state.nu[n]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        p32 = state.master[n] if state.master is not None else p
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * p32
        p32.sub_(lr * upd)
        if state.master is not None:
            p.copy_(p32)            # cast to the param dtype
    return params, AdamWState(step, state.mu, state.nu, state.master), {
        "grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------
def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    def lr(step):
        step = float(step)
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (final_frac + (1 - final_frac)
                          * 0.5 * (1 + math.cos(math.pi * prog)))
    return lr


def wsd_schedule(peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM): flat plateau, sharp final decay."""
    decay_start = int(total * (1 - decay_frac))

    def lr(step):
        step = float(step)
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        if step < decay_start:
            return peak_lr
        prog = min(max((step - decay_start) / max(total - decay_start, 1),
                       0.0), 1.0)
        return peak_lr * math.exp(math.log(final_frac) * prog)
    return lr
