"""Core layers: norms, rotary embeddings, linear/MLP, embeddings.

``nn.Module``s hold the weights in the reference's layout (a linear weight
is ``(d_in, d_out)``, a norm scale is gemma-style ``1 + w``), so weights
carried over from the JAX package need no transposes; the functions mirror
``repro/layers/core.py`` operation for operation.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def check_impl(impl: str):
    """The layers' implementation switch: ``"kernel"`` (the kernels'
    wrappers) or ``"ref"`` (their plain versions)."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")


def trunc_normal(shape, std: float, dtype: torch.dtype,
                 generator: torch.Generator, device) -> torch.Tensor:
    """``std`` x a standard normal truncated to [-2, 2] (the reference's
    ``jax.random.truncated_normal`` init), drawn in float32 from
    ``generator`` then cast."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                          generator=generator)
    return (t * std).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param(torch.zeros(d, dtype=dtype, device=device))


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p.scale.float())).to(dt)


def qk_head_norm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the head_dim of (..., H, hd) tensors (gemma3's
    qk-norm): float32, then times ``1 + scale``, cast back."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def select_update(buf: torch.Tensor, new: torch.Tensor,
                  slot: torch.Tensor) -> torch.Tensor:
    """Write ``new[b]`` into ``buf[b, slot[b]]`` IN PLACE and return
    ``buf``: one indexed write of B rows (the reference's one-hot select
    copies the whole buffer to stay off XLA's bf16 scatter)."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, slot.long()] = new.to(buf.dtype)
    return buf


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class Linear(nn.Module):
    """``y = x @ w + b`` with ``w`` of shape (d_in, d_out)."""

    def __init__(self, d_in: int, d_out: int, dtype, device, *,
                 bias: bool = False, std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        std = std if std is not None else 1.0 / math.sqrt(d_in)
        w = (trunc_normal((d_in, d_out), std, dtype, generator, device)
             if generator is not None
             else torch.zeros((d_in, d_out), dtype=dtype, device=device))
        self.w = _param(w)
        self.b = (_param(torch.zeros(d_out, dtype=dtype, device=device))
                  if bias else None)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "swiglu":
        return F.silu(x)
    if name in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return torch.square(F.relu(x))
    raise ValueError(name)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.dtype()
        self.up = Linear(d, f, dt, device, generator=generator)
        self.down = Linear(f, d, dt, device, std=1.0 / math.sqrt(f),
                           generator=generator)
        self.gate = (Linear(d, f, dt, device, generator=generator)
                     if cfg.activation in ("swiglu", "geglu") else None)


def mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    up = linear(p.up, x)
    if p.gate is not None:
        h = _act(cfg.activation, linear(p.gate, x)) * up
    else:
        h = _act(cfg.activation, up)
    return linear(p.down, h)


class Embedding(nn.Module):
    """Token embeddings ``tok`` (vocab, d); an untied LM head ``head``
    (d, vocab) unless the config ties them."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape, dt = (cfg.vocab_size, cfg.d_model), cfg.dtype()
        self.tok = _param(
            trunc_normal(shape, 0.02, dt, generator, device)
            if generator is not None
            else torch.zeros(shape, dtype=dt, device=device))
        self.head = None
        if not cfg.tie_embeddings:
            hshape = (cfg.d_model, cfg.vocab_size)
            self.head = _param(
                trunc_normal(hshape, 1.0 / math.sqrt(cfg.d_model), dt,
                             generator, device)
                if generator is not None
                else torch.zeros(hshape, dtype=dt, device=device))


def embed(p: Embedding, cfg: ModelConfig, tokens: torch.Tensor
          ) -> torch.Tensor:
    x = p.tok.to(cfg.torch_compute_dtype())[tokens.long()]
    if cfg.embed_scale:
        # sqrt(d) rounded to the compute dtype first, as the reference does
        # (in bf16 55.43 becomes 55.5 at gemma-7b's d 3,072)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(p: Embedding, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if p.head is None:
        logits = x @ p.tok.to(x.dtype).T
    else:
        logits = x @ p.head.to(x.dtype)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
