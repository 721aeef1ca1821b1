"""Decoder LM for the paged serving runtime — the dense subset of
``repro/models/lm.py``.

The reference stacks layer groups for ``lax.scan``; here the model is an
``nn.Module`` whose ``blocks`` are one module per layer and the step is a
Python loop over them (PyTorch runs eagerly). The dense family has one
sub-layer per group, so the reference's group g is this model's layer g.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.layers import attention as attn
from repro_torch.layers.core import (MLP, Embedding, RMSNorm, embed, mlp,
                                     rms_norm, unembed)


class Block(nn.Module):
    """One pre-norm transformer layer: attention then a (gated) MLP."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = cfg.dtype()
        self.n1 = RMSNorm(cfg.d_model, dt, device)
        self.mix = attn.Attention(cfg, device, generator)
        self.n2 = RMSNorm(cfg.d_model, dt, device)
        self.ffn = MLP(cfg, device, generator)


class DenseLM(nn.Module):
    """Weights of a dense decoder LM under the reference's names:
    ``embed.tok``, ``blocks[l].{n1, mix, n2, ffn}``, ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not supports_paged(cfg):
            raise ValueError(f"{cfg.name}: not paged-servable by the port")
        self.embed = Embedding(cfg, device, generator)
        self.blocks = nn.ModuleList(Block(cfg, device, generator)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype(), device)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> DenseLM:
    """Random weights with the reference's keys, shapes and init scales
    (trunc-normal, 1/sqrt(d_in) linears, 0.02 embeddings, zero biases and
    norm scales), drawn from ``generator`` on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, weights on "
                         f"{device}")
    return DenseLM(cfg, device, generator)


def supports_paged(cfg: ModelConfig) -> bool:
    """True for the families whose whole dynamic context the port keeps on
    pages: dense full (unwindowed, uncapped) GQA/MQA attention."""
    return (cfg.family == DENSE and cfg.sliding_window == 0
            and cfg.global_layer_every == 0 and cfg.attn_logit_softcap == 0
            and cfg.n_prefix_embeds == 0)


def paged_layout(cfg: ModelConfig) -> dict:
    """Dynamic-context planes of the family: the dense family has one token
    plane, ``kv``, with payload ``(2, n_kv, page, hd)`` per layer."""
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    native = cfg.torch_compute_dtype()
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    itemsize = torch.empty((), dtype=native).element_size()
    return {"kv": dict(kind="tokens", positions=[0], dtype=native,
                       dims=(K, hd), token_bytes=2 * K * hd * itemsize,
                       shareable=True)}


def serve_step_paged(model: DenseLM, cfg: ModelConfig, tokens, pools,
                     block_tables, q_starts, n_reals, *, n_decode: int,
                     read_pps: Optional[int] = None, impl: str = "kernel"):
    """ONE fused engine step: every scheduled decode token and every
    request's prompt chunk in a single call, one attention launch per
    layer.

    tokens: (R, Tc) int packed rows. Rows ``[:n_decode]`` are decode lanes
    (the next token at column 0, ``q_starts[r]`` its position,
    ``n_reals[r] = 1``; idle lanes hold token 0 at position 0 against the
    scratch page); rows ``[n_decode:]`` are prefill chunk rows with
    ``n_reals[r]`` prompt tokens from ``q_starts[r]`` (``n_real == 0``: a
    pad row on scratch). pools: {"kv": (P,2,K,page,hd)} LOCAL pool, updated
    in place; block_tables: {"kv": (n_layers, 1, R, pps_pad)} int32 slots
    (the reference's (G, n_sub, R, pps_pad)); q_starts / n_reals: (R,) host
    integer arrays. ``impl``: ``"kernel"`` or ``"ref"``.
    -> (logits (R, V) of each row's last real token, pools)
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    pool = pools["kv"]
    device = pool.device
    bt_host = np.asarray(block_tables["kv"])
    if bt_host.size and (bt_host.min() < 0 or bt_host.max() >= pool.shape[0]):
        raise ValueError("serve_step_paged: block table slot outside the "
                         f"pool of {pool.shape[0]} pages")
    bt = torch.as_tensor(bt_host.astype(np.int32)).to(device)
    tokens = torch.as_tensor(np.asarray(tokens)).to(device)
    R, Tc = tokens.shape
    qs = np.asarray(q_starts, np.int64).reshape(-1)
    nr = np.asarray(n_reals, np.int64).reshape(-1)
    meta = attn.step_meta(qs, nr, n_decode, Tc, device)

    x = embed(model.embed, cfg, tokens)
    for layer, blk in enumerate(model.blocks):
        h = rms_norm(blk.n1, x, cfg.rmsnorm_eps)
        h, pool = attn.attention_mixed_paged(
            blk.mix, cfg, h, pool, bt[layer, 0], qs, nr, n_decode=n_decode,
            read_pps=read_pps, impl=impl, meta=meta)
        x = x + h
        h = rms_norm(blk.n2, x, cfg.rmsnorm_eps)
        x = x + mlp(blk.ffn, cfg, h)
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    last_idx = torch.as_tensor(np.clip(nr - 1, 0, Tc - 1)).to(device)
    last = x[torch.arange(R, device=device), last_idx]
    logits = unembed(model.embed, cfg, last)
    return logits, {**pools, "kv": pool}
