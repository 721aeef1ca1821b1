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


def _device_tables(name: str, block_tables: dict, pool) -> torch.Tensor:
    """The kv plane's host block tables as int32 on the pool's device,
    after checking on the host that every slot lies in the pool."""
    bt_host = np.asarray(block_tables["kv"])
    if bt_host.size and (bt_host.min() < 0 or bt_host.max() >= pool.shape[0]):
        raise ValueError(f"{name}: block table slot outside the pool of "
                         f"{pool.shape[0]} pages")
    return torch.as_tensor(bt_host.astype(np.int32)).to(pool.device)


def _layer(blk: Block, cfg: ModelConfig, x, attend):
    """One pre-norm layer; ``attend(mix, h) -> out`` runs the attention."""
    x = x + attend(blk.mix, rms_norm(blk.n1, x, cfg.rmsnorm_eps))
    return x + mlp(blk.ffn, cfg, rms_norm(blk.n2, x, cfg.rmsnorm_eps))


def prefill_chunk_paged(model: DenseLM, cfg: ModelConfig, tokens, pools,
                        block_tables, q_start: int, last_index: int, *,
                        read_pps: Optional[int] = None, impl: str = "kernel"):
    """Prefill ONE CHUNK of one request, writing its K/V straight into the
    page pool.

    tokens: (1, Tc) int — the chunk, bucket-padded (rows past the real
    length are attended causally like any other and overwritten by later
    chunks or decode); pools: {"kv": (P,2,K,page,hd)} LOCAL pool, updated in
    place; block_tables: {"kv": (n_layers, 1, pps_pad)} int32 slots from
    position 0, scratch-padded (``PagedStateRuntime.block_tables_prefill``);
    q_start: the chunk's absolute start position; last_index: the row whose
    logits the caller wants. ``read_pps`` bounds the attention sweep.
    -> (logits (1, V) of ``last_index``, pools)
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    pool = pools["kv"]
    bt = _device_tables("prefill_chunk_paged", block_tables, pool)
    tokens = torch.as_tensor(np.asarray(tokens)).to(pool.device)
    if tokens.shape[0] != 1:
        raise ValueError("chunked prefill is per-request")
    Tc = tokens.shape[1]
    meta = attn.step_meta([q_start], [Tc], 0, Tc, pool.device)

    x = embed(model.embed, cfg, tokens)
    for layer, blk in enumerate(model.blocks):
        x = _layer(blk, cfg, x, lambda mix, h: attn.attention_prefill_chunk(
            mix, cfg, h, pool, bt[layer, 0], q_start, read_pps=read_pps,
            impl=impl, meta=meta)[0])
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    logits = unembed(model.embed, cfg, x[:, int(last_index)])
    return logits, {**pools, "kv": pool}


def decode_step_paged(model: DenseLM, cfg: ModelConfig, pools, block_tables,
                      tokens, pos, *, impl: str = "kernel"):
    """One token for every lane against the page pool.

    tokens / pos: (B,) host ints — each lane's next token and its position
    (idle lanes: token 0 at position 0 on scratch); pools: {"kv": pool}
    updated in place; block_tables: {"kv": (n_layers, 1, B, pps)} int32
    LOCAL slots (``PagedStateRuntime.block_tables``).
    -> (logits (B, V), pools)
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    pool = pools["kv"]
    bt = _device_tables("decode_step_paged", block_tables, pool)
    pos = np.asarray(pos, np.int64).reshape(-1)
    meta = attn.decode_meta(pos, pool.device)
    tokens = torch.as_tensor(np.asarray(tokens).reshape(-1, 1)).to(pool.device)

    x = embed(model.embed, cfg, tokens)
    for layer, blk in enumerate(model.blocks):
        x = _layer(blk, cfg, x, lambda mix, h: attn.attention_decode_paged(
            mix, cfg, h, pool, bt[layer, 0], pos, impl=impl, meta=meta)[0])
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    return unembed(model.embed, cfg, x[:, 0]), {**pools, "kv": pool}


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
    bt = _device_tables("serve_step_paged", block_tables, pool)
    tokens = torch.as_tensor(np.asarray(tokens)).to(device)
    R, Tc = tokens.shape
    qs = np.asarray(q_starts, np.int64).reshape(-1)
    nr = np.asarray(n_reals, np.int64).reshape(-1)
    meta = attn.step_meta(qs, nr, n_decode, Tc, device)

    x = embed(model.embed, cfg, tokens)
    for layer, blk in enumerate(model.blocks):
        x = _layer(blk, cfg, x, lambda mix, h: attn.attention_mixed_paged(
            mix, cfg, h, pool, bt[layer, 0], qs, nr, n_decode=n_decode,
            read_pps=read_pps, impl=impl, meta=meta)[0])
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    last_idx = torch.as_tensor(np.clip(nr - 1, 0, Tc - 1)).to(device)
    last = x[torch.arange(R, device=device), last_idx]
    logits = unembed(model.embed, cfg, last)
    return logits, {**pools, "kv": pool}
