"""Core layers: norms, rotary embeddings, linear/MLP, embeddings.

``nn.Module``s hold the weights in the reference's layout (a linear weight
is ``(d_in, d_out)``, a norm scale is gemma-style ``1 + w``), so weights
carried over from the JAX package need no transposes; the functions mirror
``repro/layers/core.py`` operation for operation.

With a rank context ``ctx`` (``distributed/partition.py``) the layers run on
a rank's shards, as the reference's partitioner splits them: an
in-projection's columns (``linear_cols``) and an out-projection's rows
(``linear_rows``, then one all-reduce over ``model``), Megatron-style; a
vocab-parallel embedding (mask, local lookup, all-reduce) and unembedding
(local vocab slice, all-gather) where ``tok``'s spec splits the vocabulary;
a weight whose spec names ``data`` (FSDP) all-gathered over that axis just
before use. Without ``ctx`` they run as they always did.

The same layers run the partitioned train step (the collectives are
differentiable: ``distributed/partition.py``). A sharded MLP's input
enters the rank's work through ``ctx.enter``, or, under sequence
parallelism (``sp``: the residual stream split along T over ``model``),
is all-gathered along T, and its out-projection's partial sums are then
reduce-scattered along T instead of all-reduced. A weight or bias
replicated over ``model`` that a rank's own work consumes enters it the
same way, so that its gradient is summed over the axis.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.partition import AXES, pspec, splits


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


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6,
             ctx=None) -> torch.Tensor:
    """With ``ctx``, x is the rank's own work (its block of the positions
    under sequence parallelism): the scale enters it (``own_weight``)."""
    dt = x.dtype
    scale = p.scale if ctx is None else own_weight(p, "scale", ctx)
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


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


def own_weight(p: nn.Module, name: str, ctx,
               axes=("data",)) -> torch.Tensor:
    """A sharded module's parameter ``name`` for the rank's own work: its
    shards gathered over ``axes`` (``ctx.gather``; FSDP's with the
    default); one replicated over ``model`` entered first (``ctx.enter``:
    its gradient summed over the axis)."""
    t, spec = getattr(p, name), pspec(p, name)
    return ctx.gather(t if splits(spec) else ctx.enter(t), spec, axes)


def linear_cols(p: Linear, x: torch.Tensor, ctx):
    """An in-projection on a rank: x (..., d_in) times the rank's columns
    of ``w`` (all of them where its spec does not split the output over
    ``model``), plus that slice of the bias -> (y, lo, hi), y holding the
    global output features [lo, hi)."""
    w = own_weight(p, "w", ctx)
    lo, hi = ctx.range(pspec(p, "w")[1], w.shape[1])
    y = x @ w.to(x.dtype)
    if p.b is not None:
        b = own_weight(p, "b", ctx)
        y = y + (b if b.shape[0] == hi - lo else b[lo:hi]).to(x.dtype)
    return y, lo, hi


def linear_rows(p: Linear, x: torch.Tensor, lo: int, hi: int, ctx,
                scatter: Optional[int] = None):
    """An out-projection on a rank: x holds the global input features
    [lo, hi); the rank's rows of ``w`` (a sub-range of them) make a partial
    product, all-reduced over ``model`` where the spec splits the rows
    (with ``scatter``, reduce-scattered along that dim instead: sequence
    parallelism); then the bias."""
    ws = pspec(p, "w")
    w = ctx.gather(p.w, ws)
    rlo, rhi = ctx.range(ws[0], w.shape[0])
    if not (lo <= rlo and rhi <= hi):
        raise ValueError(f"features [{lo}, {hi}) do not cover the rank's "
                         f"rows [{rlo}, {rhi})")
    if (rlo, rhi) != (lo, hi):
        x = x[..., rlo - lo:rhi - lo]
    y = x @ w.to(x.dtype)
    if scatter is not None:
        if ws[0] is None:
            raise ValueError("sequence parallelism needs the out-"
                             "projection's rows split over model")
        y = ctx.reduce_scatter(y, scatter, ws[0])
    elif ws[0] is not None:
        y = ctx.all_reduce(y, ws[0])
    if p.b is not None:
        b = (own_weight(p, "b", ctx) if scatter is not None
             else ctx.gather(p.b, pspec(p, "b")))
        y = y + b.to(x.dtype)
    return y


def linear_gathered(pairs, ctx, alike: bool = False):
    """In-projections on a rank with every output column: ``pairs`` of
    (Linear, its input); each projection's column slice (``linear_cols``),
    those that are split concatenated into ONE all-gather over ``model``
    (a projection whose columns are not split is whole already) -> the
    outputs, each (..., d_out). With ``alike`` the outputs feed work every
    rank does alike, not the rank's own (``RankContext.all_gather``)."""
    outs = [linear_cols(p, x, ctx)[0] for p, x in pairs]
    split = [pspec(p, "w")[1] is not None for p, _ in pairs]
    if any(split):
        lead = outs[0].shape[:-1]
        widths = [o.shape[-1] for o, s in zip(outs, split) if s]
        full = ctx.all_gather(torch.cat([o for o, s in zip(outs, split)
                                         if s], -1), -1, "model", alike)
        parts = iter(full.reshape(*lead, ctx.model_n, -1).split(widths, -1))
        outs = [next(parts).reshape(*lead, -1) if s else o
                for o, s in zip(outs, split)]
    return outs


def whole(p: nn.Module, name: str, ctx) -> torch.Tensor:
    """A sharded module's parameter ``name`` all-gathered over every axis
    its spec names: the whole tensor (small weights a rank uses in full).
    The work on it is the rank's own, as ``own_weight`` takes it: in
    training what a rank computes from it feeds only its own shares, so
    its gradient is summed over ``model``."""
    return own_weight(p, name, ctx, AXES)


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


def mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor, ctx=None,
        sp: bool = False) -> torch.Tensor:
    """With ``ctx``: column-split up / gate, row-split down, one
    all-reduce. With ``sp``, x is the rank's block of the positions
    (B, T / model, d): all-gathered along T before the projections, the
    partial sums reduce-scattered along T after ``down``."""
    if ctx is None:
        up = linear(p.up, x)
        gate = linear(p.gate, x) if p.gate is not None else None
        return linear(p.down, _gated(cfg, up, gate))
    x = ctx.all_gather(x, 1, "model") if sp else ctx.enter(x)
    up, lo, hi = linear_cols(p.up, x, ctx)
    gate = linear_cols(p.gate, x, ctx)[0] if p.gate is not None else None
    return linear_rows(p.down, _gated(cfg, up, gate), lo, hi, ctx,
                       scatter=1 if sp else None)


def _gated(cfg: ModelConfig, up, gate) -> torch.Tensor:
    if gate is not None:
        return _act(cfg.activation, gate) * up
    return _act(cfg.activation, up)


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


def embed(p: Embedding, cfg: ModelConfig, tokens: torch.Tensor, ctx=None
          ) -> torch.Tensor:
    """With ``ctx`` and a ``tok`` whose spec splits the vocabulary over
    ``model``: the rank looks up the tokens in its slice, zeroes the
    others' rows and all-reduces (one rank adds each row, the rest add
    zeros: exact)."""
    tok, axis = p.tok, None
    if ctx is not None:
        ts = pspec(p, "tok")
        tok, axis = ctx.gather(tok, ts), ts[0]
    tok = tok.to(cfg.torch_compute_dtype())
    if axis is None:
        x = tok[tokens.long()]
    else:
        lo, _ = ctx.range(axis, tok.shape[0])
        local = tokens.long() - lo
        own = (local >= 0) & (local < tok.shape[0])
        x = tok[local.clamp(0, tok.shape[0] - 1)]
        x = ctx.all_reduce(torch.where(own[..., None], x,
                                       torch.zeros_like(x)), axis)
    if cfg.embed_scale:
        # sqrt(d) rounded to the compute dtype first, as the reference does
        # (in bf16 55.43 becomes 55.5 at gemma-7b's d 3,072)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def vocab_axis(p: Embedding):
    """The mesh axis a sharded embedding's unembedding splits its
    vocabulary over, or None."""
    tied = p.head is None
    return pspec(p, "tok" if tied else "head")[0 if tied else 1]


def unembed(p: Embedding, cfg: ModelConfig, x: torch.Tensor, ctx=None,
            local: bool = False) -> torch.Tensor:
    """With ``ctx``: the rank's vocabulary slice of the logits, all-gathered
    over ``model`` where the spec splits the vocabulary. With ``local``
    (the train step: x is the rank's own work), the rank's logits as they
    are, a weight replicated over ``model`` entering the rank's work."""
    tied = p.head is None
    name = "tok" if tied else "head"
    w, axis = getattr(p, name), None
    if ctx is not None:
        w = (own_weight(p, name, ctx) if local
             else ctx.gather(w, pspec(p, name)))
        axis = None if local else vocab_axis(p)
    logits = x @ (w.to(x.dtype).T if tied else w.to(x.dtype))
    if axis is not None:
        logits = ctx.all_gather(logits, -1, axis)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
