"""Whisper-style encoder-decoder — ``repro/models/encdec.py``.

The audio conv frontend is a stub, as in the reference: callers pass frame
embeddings ``enc_embeds`` (B, T_enc, d_model). The encoder is a stack of
pre-norm layers of bidirectional self-attention (RoPE at the frame index)
and an MLP; each decoder layer is causal self-attention, cross-attention
over the encoder output and an MLP. RMSNorm and RoPE stand in for
LayerNorm and learned positions, as in the reference.

Attention goes through the flash op: the encoder's at ``causal=False`` over
T_enc frames, the decoder's self-attention causal (``attention_full``), the
cross-attention at ``causal=False`` with Sq decoder rows against T_enc keys
(``attention_bidir``); ``impl="kernel"`` runs the CUDA kernels on a card
(their plain versions on the CPU), ``impl="ref"`` the plain versions under
autograd. The dense cache's decode self-attention is the reference's
einsum over the cache (``attention_decode``). The reference scans stacked
layers; here each layer is a module and the stack a Python loop.

The dense decode cache holds, per decoder layer, a self ``KVCache`` of
``seq`` slots and a cross ``KVCache`` of T_enc slots, computed once at
prefill (the reference's layout: ``{"self": KVCache, "cross": KVCache}``,
each leaf stacked over the decoder layers). No page plane exists for it:
the engines refuse the family (``api.supports_paged``). ``prefill`` and
``decode_step`` with ``shard_axes`` run one rank of a mesh on its
shards, and so do ``forward`` and ``loss_fn`` (the partitioned train
step).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ENCDEC, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.distributed.partition import own_slices
from repro_torch.layers import attention as attn
from repro_torch.layers.core import (MLP, Embedding, Linear, RMSNorm,
                                     check_impl, embed, linear,
                                     linear_gathered, mlp, rms_norm,
                                     unembed, vocab_axis)
from repro_torch.models.lm import _at, _tokens_on
from repro_torch.models.losses import shifted_xent


class Cross(nn.Module):
    """Cross-attention weights ``wq``, ``wk``, ``wv``, ``wo``."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.resolved_head_dim, cfg.dtype()
        kw = dict(generator=generator)
        self.wq = Linear(d, cfg.n_heads * hd, dt, device, **kw)
        self.wk = Linear(d, cfg.n_kv_heads * hd, dt, device, **kw)
        self.wv = Linear(d, cfg.n_kv_heads * hd, dt, device, **kw)
        self.wo = Linear(cfg.n_heads * hd, d, dt, device, **kw)


class EncBlock(nn.Module):
    """``n1``, ``attn`` (bidirectional), ``n2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = cfg.dtype()
        self.n1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = attn.Attention(cfg, device, generator)
        self.n2 = RMSNorm(cfg.d_model, dt, device)
        self.ffn = MLP(cfg, device, generator)


class DecBlock(nn.Module):
    """``n1``, ``self`` (causal self-attention), ``n2``, ``cross``, ``n3``,
    ``ffn``."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = cfg.dtype()
        self.n1 = RMSNorm(cfg.d_model, dt, device)
        self.self = attn.Attention(cfg, device, generator)
        self.n2 = RMSNorm(cfg.d_model, dt, device)
        self.cross = Cross(cfg, device, generator)
        self.n3 = RMSNorm(cfg.d_model, dt, device)
        self.ffn = MLP(cfg, device, generator)


class EncDec(nn.Module):
    """Weights under the reference's names: ``embed.tok`` (and
    ``embed.head`` when untied), ``enc_blocks[e]``, ``enc_norm``,
    ``dec_blocks[l]``, ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != ENCDEC or cfg.encdec is None:
            raise ValueError(f"{cfg.name}: not an encoder-decoder config")
        dt = cfg.dtype()
        self.embed = Embedding(cfg, device, generator)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, device, generator)
            for _ in range(cfg.encdec.n_encoder_layers))
        self.enc_norm = RMSNorm(cfg.d_model, dt, device)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device, generator)
                                        for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, dt, device)
        self.cfg = cfg


def param_specs(cfg: ModelConfig) -> EncDec:
    """The model on the ``meta`` device: shapes and dtypes, no storage."""
    return EncDec(cfg, torch.device("meta"))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> EncDec:
    """Random weights with the reference's keys, shapes and init scales
    (trunc-normal, 1/sqrt(d_in) linears, 0.02 embeddings, zero norm
    scales), drawn from ``generator`` on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, weights on "
                         f"{device}")
    return EncDec(cfg, device, generator)


def encode(model: EncDec, cfg: ModelConfig, enc_embeds, *,
           impl: str = "kernel", rank=None) -> torch.Tensor:
    """enc_embeds (B,T_enc,d) -> the normed encoder output (B,T_enc,d) in
    the compute dtype, on the model's device. With ``rank`` (a rank's
    shards): the bidirectional attention over the q heads the rank's
    ``wo`` rows touch, the MLP split; the output whole on every rank."""
    device = model.embed.tok.device
    x = enc_embeds.to(device=device, dtype=cfg.torch_compute_dtype())
    eps = cfg.rmsnorm_eps
    for blk in model.enc_blocks:
        h = rms_norm(blk.n1, x, eps)
        x = x + (attn.attention_bidir(blk.attn, cfg, h, impl=impl)
                 if rank is None else
                 attn.attention_bidir_sharded(blk.attn, cfg, h, rank,
                                              impl=impl))
        x = x + mlp(blk.ffn, cfg, rms_norm(blk.n2, x, eps), rank)
    return rms_norm(model.enc_norm, x, eps)


def cross_kv(p: Cross, cfg: ModelConfig, enc_out):
    """The cross-attention's K/V (B,T_enc,K,hd) of the encoder output."""
    B, Te, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = linear(p.wk, enc_out).reshape(B, Te, cfg.n_kv_heads, hd)
    v = linear(p.wv, enc_out).reshape(B, Te, cfg.n_kv_heads, hd)
    return k, v


def _cross_and_mlp(blk: DecBlock, cfg: ModelConfig, x, ck, cv, impl: str):
    eps = cfg.rmsnorm_eps
    x = x + attn.attention_bidir(blk.cross, cfg, rms_norm(blk.n2, x, eps),
                                 kv=(ck, cv), impl=impl)
    return x + mlp(blk.ffn, cfg, rms_norm(blk.n3, x, eps))


def _cross_kv_sharded(p: Cross, cfg: ModelConfig, enc_out, rank):
    """``cross_kv`` on a rank: the projections' column slices all-gathered
    whole in one collective."""
    B, Te, _ = enc_out.shape
    return tuple(t.reshape(B, Te, cfg.n_kv_heads, cfg.resolved_head_dim)
                 for t in linear_gathered([(p.wk, enc_out),
                                           (p.wv, enc_out)], rank))


def _dec_train_layer(blk: DecBlock, cfg: ModelConfig, x, enc_out,
                     impl: str, rank=None):
    """One decoder layer of the training forward (the reference's scan
    body): causal self-attention, cross-attention over the encoder
    output's K/V, the MLP. With ``rank`` (the partitioned train step, the
    stream replicated over ``model``, as the reference leaves it): the
    self-attention through ``attention_train_sharded`` (whisper's heads
    that do not divide ``model``: the covered route), the cross K/V's
    column slices all-gathered whole (``_cross_kv_sharded``), the
    cross-attention over the q heads the rank's ``wo`` rows touch, the
    split MLP."""
    eps = cfg.rmsnorm_eps
    if rank is None:
        ck, cv = cross_kv(blk.cross, cfg, enc_out)
        x = x + attn.attention_full(blk.self, cfg, rms_norm(blk.n1, x, eps),
                                    impl=impl)
        return _cross_and_mlp(blk, cfg, x, ck, cv, impl)
    ck, cv = _cross_kv_sharded(blk.cross, cfg, enc_out, rank)
    x = x + attn.attention_train_sharded(
        blk.self, cfg, rms_norm(blk.n1, x, eps), rank, window=0, sp=False,
        impl=impl)
    x = x + attn.attention_bidir_sharded(
        blk.cross, cfg, rms_norm(blk.n2, x, eps), rank, kv=(ck, cv),
        impl=impl)
    return x + mlp(blk.ffn, cfg, rms_norm(blk.n3, x, eps), rank)


def forward(model: EncDec, cfg: ModelConfig, tokens, enc_embeds, *,
            remat: bool = False, impl: str = "kernel", shard_axes=None):
    """Training forward: decoder tokens (B,T) and ``enc_embeds``
    (B,T_enc,d), both moved to the model's device -> (logits (B,T,V), a
    zero float32 aux loss). ``remat`` recomputes each decoder layer in the
    backward (``torch.utils.checkpoint``; the reference checkpoints the
    decoder's scan body alone).

    ``shard_axes`` (with ``"ctx"``, the rank's ``RankContext``): the
    partitioned train step on one rank (the reference's GSPMD over the
    same rules), ``model`` and the inputs its shards and rows. The
    encoder on the q heads the rank's ``wo`` rows touch with the MLP
    split (``encode``); its output, replicated over ``model``, enters the
    rank's work (each decoder layer's cross K/V columns); the decoder's
    layers by ``_dec_train_layer``. The logits are the rank's vocabulary
    slice where the unembedding's spec splits the vocabulary, else all of
    them."""
    check_impl(impl)
    rank = shard_axes["ctx"] if shard_axes else None
    device = model.embed.tok.device
    enc_out = encode(model, cfg, enc_embeds, impl=impl, rank=rank)
    if rank is not None:
        enc_out = rank.enter(enc_out)
    x = embed(model.embed, cfg, _tokens_on(tokens, device), rank)
    for blk in model.dec_blocks:
        if remat:
            x = checkpoint(_dec_train_layer, blk, cfg, x, enc_out, impl,
                           rank, use_reentrant=False)
        else:
            x = _dec_train_layer(blk, cfg, x, enc_out, impl, rank)
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    if rank is None:
        return unembed(model.embed, cfg, x), aux
    if vocab_axis(model.embed) is None:
        return unembed(model.embed, cfg, x, rank), aux
    return unembed(model.embed, cfg, rank.enter(x), rank, local=True), aux


def loss_fn(model: EncDec, cfg: ModelConfig, batch: dict, *,
            remat: bool = False, impl: str = "kernel", shard_axes=None):
    """Next-token cross-entropy of ``batch["tokens"]`` given
    ``batch["enc_embeds"]`` -> float32 scalar. ``shard_axes``: the rank's
    loss in the partitioned train step (its rows' mean, the same on every
    rank of its ``model`` group), through the vocab-parallel
    ``shifted_xent`` where the vocabulary is split."""
    tokens = _tokens_on(batch["tokens"], model.embed.tok.device)
    logits, _ = forward(model, cfg, tokens, batch["enc_embeds"],
                        remat=remat, impl=impl, shard_axes=shard_axes)
    vocab = vocab_axis(model.embed) if shard_axes else None
    if vocab is not None:
        return shifted_xent(logits, tokens, {"ctx": shard_axes["ctx"],
                                             "vocab": vocab})
    return shifted_xent(logits, tokens)


def init_decode_state(cfg: ModelConfig, batch: int, seq: int, dtype=None,
                      device=None) -> dict:
    """``{"self": KVCache (L, B, seq, K, hd), "cross": KVCache (L, B,
    T_enc, K, hd)}``, zeros in ``dtype`` (the compute dtype by default)
    on ``device`` (CUDA unless the caller passes another; raises when
    CUDA is absent)."""
    device = resolve_device(device)
    dt = dtype or cfg.torch_compute_dtype()
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim

    def kv(slots):
        shape = (L, batch, slots, K, hd)
        return attn.KVCache(torch.zeros(shape, dtype=dt, device=device),
                            torch.zeros(shape, dtype=dt, device=device))
    return {"self": kv(seq), "cross": kv(cfg.encdec.encoder_seq_len)}


def decode_state_specs(cfg: ModelConfig, batch: int, seq: int,
                       dtype=None) -> dict:
    """``init_decode_state``'s tree on the ``meta`` device."""
    return init_decode_state(cfg, batch, seq, dtype, device="meta")


@torch.no_grad()
def prefill(model: EncDec, cfg: ModelConfig, tokens, cache: dict, *,
            enc_embeds, impl: str = "kernel", shard_axes=None):
    """Decoder tokens (B,T), ``enc_embeds`` (B,T_enc,d) and an empty cache
    from ``init_decode_state`` -> (the last position's logits (B,V), the
    cache, filled in place): each layer's self K/V in slots [0, T), its
    cross K/V of the encoder output in the cache's dtype.

    ``shard_axes`` (with ``"ctx"``, the rank's ``RankContext``): the
    partitioned step on one rank, ``model``, ``cache`` and the inputs its
    shards. The encoder on the rank's heads (``encode``), the decoder's
    self-attention on the route its cache's spec picks
    (``attention_prefill_sharded``), the cross K/V gathered whole and the
    rank's block written to its cross cache, the cross-attention over the
    q heads its ``wo`` rows touch, the MLPs split."""
    check_impl(impl)
    rank = shard_axes["ctx"] if shard_axes else None
    device = model.embed.tok.device
    enc_out = encode(model, cfg, enc_embeds, impl=impl, rank=rank)
    x = embed(model.embed, cfg, _tokens_on(tokens, device), rank)
    eps = cfg.rmsnorm_eps
    for layer, blk in enumerate(model.dec_blocks):
        cross = _at(cache["cross"], layer)
        if rank is None:
            ck, cv = cross_kv(blk.cross, cfg, enc_out)
            h, (k, v) = attn.attention_full(
                blk.self, cfg, rms_norm(blk.n1, x, eps), return_kv=True,
                impl=impl)
            attn.fill_kv_cache(_at(cache["self"], layer), k, v)
            cross.k.copy_(ck)
            cross.v.copy_(cv)
            x = _cross_and_mlp(blk, cfg, x + h, ck, cv, impl)
            continue
        ck, cv = _cross_kv_sharded(blk.cross, cfg, enc_out, rank)
        x = x + attn.attention_prefill_sharded(
            blk.self, cfg, rms_norm(blk.n1, x, eps),
            _at(cache["self"], layer), window=0,
            spec=cache["self"].k.pspec, rank=rank, impl=impl)
        own = own_slices(cross.k, cache["cross"].k.pspec[1:], rank, (1, 2))
        cross.k.copy_(ck[own])
        cross.v.copy_(cv[own])
        x = x + attn.attention_bidir_sharded(
            blk.cross, cfg, rms_norm(blk.n2, x, eps), rank, kv=(ck, cv),
            impl=impl)
        x = x + mlp(blk.ffn, cfg, rms_norm(blk.n3, x, eps), rank)
    x = rms_norm(model.final_norm, x, eps)
    return unembed(model.embed, cfg, x[:, -1], rank), cache


@torch.no_grad()
def decode_step(model: EncDec, cfg: ModelConfig, cache: dict, tokens, pos,
                *, impl: str = "kernel", shard_axes=None):
    """One token for every sequence: tokens (B,), pos (B,) (host ints or
    tensors; a scalar pos is every lane's) -> (logits (B,V), the cache,
    its self K/V updated in place). The cross K/V is read back in the
    compute dtype; each layer's cross-attention is one row a lane against
    T_enc keys. ``shard_axes``: the partitioned step on one rank, as
    ``prefill`` takes it (self-attention by ``attention_decode_sharded``,
    cross-attention by ``cross_decode_sharded`` on its cache's route)."""
    check_impl(impl)
    rank = shard_axes["ctx"] if shard_axes else None
    device = model.embed.tok.device
    tokens = _tokens_on(tokens, device).reshape(-1, 1)
    pos = _tokens_on(pos, device).reshape(-1).long()
    x = embed(model.embed, cfg, tokens, rank)
    eps = cfg.rmsnorm_eps
    for layer, blk in enumerate(model.dec_blocks):
        cross = _at(cache["cross"], layer)
        if rank is None:
            h, _ = attn.attention_decode(
                blk.self, cfg, rms_norm(blk.n1, x, eps),
                _at(cache["self"], layer), pos)
            x = _cross_and_mlp(blk, cfg, x + h, cross.k.to(x.dtype),
                               cross.v.to(x.dtype), impl)
            continue
        x = x + attn.attention_decode_sharded(
            blk.self, cfg, rms_norm(blk.n1, x, eps),
            _at(cache["self"], layer), pos, window=0,
            spec=cache["self"].k.pspec, rank=rank)
        x = x + attn.cross_decode_sharded(
            blk.cross, cfg, rms_norm(blk.n2, x, eps), cross,
            spec=cache["cross"].k.pspec, rank=rank, impl=impl)
        x = x + mlp(blk.ffn, cfg, rms_norm(blk.n3, x, eps), rank)
    x = rms_norm(model.final_norm, x, eps)
    return unembed(model.embed, cfg, x[:, 0], rank), cache
