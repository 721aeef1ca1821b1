"""Decoder LM for training and the paged serving runtime — the dense and
RWKV-6 subset of ``repro/models/lm.py`` (training: the dense family).

The reference stacks layer groups for ``lax.scan``; here the model is an
``nn.Module`` whose ``blocks`` are one module per layer and the step is a
Python loop over them (PyTorch runs eagerly). Both families the port serves
have one sub-layer per group, so the reference's group g is this model's
layer g. A layer's sequence mixer is attention (with an MLP after it) or
RWKV-6 (time-mix and channel-mix, with their own residuals): see
``mixer_kind``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import DENSE, SSM, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.layers import attention as attn
from repro_torch.layers import rwkv6 as rwkv
from repro_torch.layers.core import (MLP, Embedding, RMSNorm, embed, mlp,
                                     rms_norm, unembed)
from repro_torch.models.losses import shifted_xent


def mixer_kind(cfg: ModelConfig) -> str:
    """Sequence mixer of every layer: ``"rwkv"`` or ``"attn"`` (both
    families the port serves are homogeneous)."""
    return "rwkv" if cfg.family == SSM else "attn"


class Block(nn.Module):
    """One pre-norm layer: ``n1``, ``mix`` (attention or RWKV), ``n2`` and,
    after attention, ``ffn``."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = cfg.dtype()
        self.n1 = RMSNorm(cfg.d_model, dt, device)
        self.n2 = RMSNorm(cfg.d_model, dt, device)
        if mixer_kind(cfg) == "rwkv":
            # the channel-mix is the RWKV block's feed-forward
            self.mix = rwkv.RWKV(cfg, device, generator)
            self.ffn = None
        else:
            self.mix = attn.Attention(cfg, device, generator)
            self.ffn = MLP(cfg, device, generator)


class LM(nn.Module):
    """Weights of a decoder LM under the reference's names: ``embed.tok``
    (and ``embed.head`` when untied), ``blocks[l].{n1, mix, n2, ffn}``,
    ``final_norm``."""

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
                device=None) -> LM:
    """Random weights with the reference's keys, shapes and init scales
    (trunc-normal, 1/sqrt(d_in) linears, 0.02 embeddings and LoRAs, zero
    biases, norm scales and token-shift mixes, RWKV decay base -6), drawn
    from ``generator`` on ``device`` (CUDA unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, weights on "
                         f"{device}")
    return LM(cfg, device, generator)


def supports_paged(cfg: ModelConfig) -> bool:
    """True for the families whose whole dynamic context the port keeps on
    pages: dense full (unwindowed, uncapped) GQA/MQA attention, and RWKV-6
    (its wkv and token-shift state)."""
    if cfg.n_prefix_embeds or cfg.attn_logit_softcap > 0:
        return False
    if cfg.family == SSM:
        return cfg.ssm is not None
    return (cfg.family == DENSE and cfg.sliding_window == 0
            and cfg.global_layer_every == 0)


def paged_layout(cfg: ModelConfig) -> dict:
    """Map every dynamic-context leaf of the family onto a page PLANE.

    Two plane kinds: ``tokens`` grows with context, ``ceil(ctx/page)``
    pages per layer (``kv``: payload ``(2, n_kv, page, hd)``, attention
    K/V); ``state`` is fixed-size recurrent state, ONE page per layer whose
    payload is exactly the leaf (``wkv``: ``(H, hd, hd)`` float32;
    ``shift``: ``(2, d_model)`` native, rows time-mix / channel-mix
    shifts). Token planes are shareable across requests with a common
    prompt prefix; state planes are not.

    Returns ``{name: {"kind", "positions", "dtype", "shareable", ...}}``
    where token planes carry ``dims`` + ``token_bytes`` and state planes
    carry ``shape``.
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    native = cfg.torch_compute_dtype()
    if mixer_kind(cfg) == "rwkv":
        rhd = cfg.ssm.rwkv_head_dim
        H = cfg.d_model // rhd
        return {"wkv": dict(kind="state", positions=[0],
                            dtype=torch.float32, shape=(H, rhd, rhd),
                            shareable=False),
                "shift": dict(kind="state", positions=[0], dtype=native,
                              shape=(2, cfg.d_model), shareable=False)}
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    itemsize = torch.empty((), dtype=native).element_size()
    return {"kv": dict(kind="tokens", positions=[0], dtype=native,
                       dims=(K, hd), token_bytes=2 * K * hd * itemsize,
                       shareable=True)}


def _device_tables(name: str, block_tables: dict, pools: dict) -> dict:
    """Each plane's host block table as int32 on its pool's device, after
    checking on the host that every slot lies in the pool."""
    out = {}
    for plane, pool in pools.items():
        bt_host = np.asarray(block_tables[plane])
        if bt_host.size and (bt_host.min() < 0
                             or bt_host.max() >= pool.shape[0]):
            raise ValueError(f"{name}: {plane} block table slot outside the "
                             f"pool of {pool.shape[0]} pages")
        out[plane] = torch.as_tensor(bt_host.astype(np.int32)).to(
            pool.device)
    return out


def _device_of(pools: dict) -> torch.device:
    return next(iter(pools.values())).device


def _layer(blk: Block, cfg: ModelConfig, x, attend):
    """One pre-norm attention layer; ``attend(mix, h) -> out`` runs the
    attention."""
    x = x + attend(blk.mix, rms_norm(blk.n1, x, cfg.rmsnorm_eps))
    return x + mlp(blk.ffn, cfg, rms_norm(blk.n2, x, cfg.rmsnorm_eps))


def _tokens_on(tokens, device) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(np.asarray(tokens))
    return tokens.to(device)


def _train_layer(blk: Block, cfg: ModelConfig, x, impl: str):
    return _layer(blk, cfg, x, lambda mix, h: attn.attention_full(
        mix, cfg, h, impl=impl))


def forward(model: LM, cfg: ModelConfig, tokens, *, remat: bool = False,
            impl: str = "kernel"):
    """Training forward of the dense family (the reference's ``forward`` and
    ``_group_train``): tokens (B,T) -> (logits (B,T,V), aux 0.0). Tokens
    move to the model's device. ``remat`` recomputes each layer in the
    backward (``torch.utils.checkpoint``, the counterpart of
    ``jax.checkpoint`` of the group body)."""
    if mixer_kind(cfg) == "rwkv":
        raise NotImplementedError(f"{cfg.name}: RWKV-6 training is not "
                                  "ported (wkv6 has no backward kernel)")
    device = model.embed.tok.device
    tokens = _tokens_on(tokens, device)
    x = embed(model.embed, cfg, tokens)
    for blk in model.blocks:
        if remat:
            x = checkpoint(_train_layer, blk, cfg, x, impl,
                           use_reentrant=False)
        else:
            x = _train_layer(blk, cfg, x, impl)
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    logits = unembed(model.embed, cfg, x)
    return logits, torch.zeros((), dtype=torch.float32, device=device)


def loss_fn(model: LM, cfg: ModelConfig, batch: dict, *,
            remat: bool = False, impl: str = "kernel"):
    """Next-token cross-entropy of ``batch["tokens"]`` (B,T) -> float32
    scalar (the dense family has no auxiliary loss)."""
    tokens = _tokens_on(batch["tokens"], model.embed.tok.device)
    logits, _ = forward(model, cfg, tokens, remat=remat, impl=impl)
    return shifted_xent(logits, tokens)


def _rwkv_layer(blk: Block, cfg: ModelConfig, x, pools: dict, ws, ss, *,
                impl: str, n_real=None):
    """One RWKV sub-layer against the state pools: the lanes' wkv and shift
    pages at slots ``ws`` / ``ss`` (B,) are read, carried through the block
    and written back in place (the reference's ``_plane_state_rwkv`` /
    ``_store_state_rwkv``). Lanes sharing a slot (idle lanes on scratch)
    write it in an undefined order."""
    shift = pools["shift"][ss.long()]                           # (B, 2, d)
    st = rwkv.RWKVState(pools["wkv"][ws.long()], shift[:, 0], shift[:, 1])
    x, nst = rwkv.rwkv_block(blk.mix, cfg, x, st,
                             {"n1": blk.n1, "n2": blk.n2}, impl=impl,
                             n_real=n_real)
    pools["wkv"][ws.long()] = nst.wkv
    pools["shift"][ss.long()] = torch.stack(
        [nst.tm_shift, nst.cm_shift], dim=-2).to(pools["shift"].dtype)
    return x


def prefill_chunk_paged(model: LM, cfg: ModelConfig, tokens, pools,
                        block_tables, q_start: int, last_index: int, *,
                        read_pps: Optional[int] = None, impl: str = "kernel"):
    """Prefill ONE CHUNK of one request, writing its state straight into the
    page pools — either family, one code path.

    tokens: (1, Tc) int — the chunk, bucket-padded (attention rows past the
    real length are attended causally like any other and overwritten by
    later chunks or decode; for the recurrent planes ``n_real = last_index
    + 1`` makes the padding an identity transition); pools: {plane: LOCAL
    pool}, updated in place; block_tables: token planes
    ``(n_layers, 1, pps_pad)`` int32 slots from position 0, scratch-padded,
    state planes ``(n_layers, 1)`` bare slots
    (``PagedStateRuntime.block_tables_prefill``); q_start: the chunk's
    absolute start position; last_index: the row whose logits the caller
    wants. ``read_pps`` bounds the attention sweep.
    -> (logits (1, V) of ``last_index``, pools)
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    device = _device_of(pools)
    bt = _device_tables("prefill_chunk_paged", block_tables, pools)
    tokens = torch.as_tensor(np.asarray(tokens)).to(device)
    if tokens.shape[0] != 1:
        raise ValueError("chunked prefill is per-request")
    Tc = tokens.shape[1]
    x = embed(model.embed, cfg, tokens)
    if mixer_kind(cfg) == "rwkv":
        for layer, blk in enumerate(model.blocks):
            x = _rwkv_layer(blk, cfg, x, pools, bt["wkv"][layer],
                            bt["shift"][layer], impl=impl,
                            n_real=int(last_index) + 1)
    else:
        pool = pools["kv"]
        meta = attn.step_meta([q_start], [Tc], 0, Tc, device)
        for layer, blk in enumerate(model.blocks):
            x = _layer(blk, cfg, x, lambda mix, h: attn.attention_prefill_chunk(
                mix, cfg, h, pool, bt["kv"][layer, 0], q_start,
                read_pps=read_pps, impl=impl, meta=meta)[0])
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    logits = unembed(model.embed, cfg, x[:, int(last_index)])
    return logits, pools


def decode_step_paged(model: LM, cfg: ModelConfig, pools, block_tables,
                      tokens, pos, *, impl: str = "kernel"):
    """One token for every lane against the page pools.

    tokens / pos: (B,) host ints — each lane's next token and its position
    (idle lanes: token 0 at position 0 on scratch); pools: {plane: pool}
    updated in place; block_tables: token planes ``(n_layers, 1, B, pps)``,
    state planes ``(n_layers, 1, B)`` int32 LOCAL slots
    (``PagedStateRuntime.block_tables``).
    -> (logits (B, V), pools)
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    device = _device_of(pools)
    bt = _device_tables("decode_step_paged", block_tables, pools)
    pos = np.asarray(pos, np.int64).reshape(-1)
    tokens = torch.as_tensor(np.asarray(tokens).reshape(-1, 1)).to(device)

    x = embed(model.embed, cfg, tokens)
    if mixer_kind(cfg) == "rwkv":
        for layer, blk in enumerate(model.blocks):
            x = _rwkv_layer(blk, cfg, x, pools, bt["wkv"][layer, 0],
                            bt["shift"][layer, 0], impl=impl)
    else:
        pool = pools["kv"]
        meta = attn.decode_meta(pos, device)
        for layer, blk in enumerate(model.blocks):
            x = _layer(blk, cfg, x, lambda mix, h: attn.attention_decode_paged(
                mix, cfg, h, pool, bt["kv"][layer, 0], pos, impl=impl,
                meta=meta)[0])
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    return unembed(model.embed, cfg, x[:, 0]), pools


def rwkv_mixed_paged(blk: Block, cfg: ModelConfig, x, pools, ws, ss, nr,
                n_decode: int, impl: str):
    """An RWKV sub-layer of a packed step, run as two row regions (the
    reference's ``_group_fwd_mixed``): the decode lanes' single tokens as a
    batched one-token step, then the chunk rows with their per-row
    ``n_real``. Decode rows keep their tail columns unchanged."""
    R, Tc, _ = x.shape
    parts = []
    if n_decode:
        x_dec = _rwkv_layer(blk, cfg, x[:n_decode, :1], pools,
                            ws[:n_decode], ss[:n_decode], impl=impl)
        if Tc > 1:
            x_dec = torch.cat([x_dec, x[:n_decode, 1:]], dim=1)
        parts.append(x_dec)
    if R > n_decode:
        parts.append(_rwkv_layer(blk, cfg, x[n_decode:], pools,
                                 ws[n_decode:], ss[n_decode:], impl=impl,
                                 n_real=nr[n_decode:]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def serve_step_paged(model: LM, cfg: ModelConfig, tokens, pools,
                     block_tables, q_starts, n_reals, *, n_decode: int,
                     read_pps: Optional[int] = None, impl: str = "kernel"):
    """ONE fused engine step: every scheduled decode token and every
    request's prompt chunk in a single call.

    tokens: (R, Tc) int packed rows. Rows ``[:n_decode]`` are decode lanes
    (the next token at column 0, ``q_starts[r]`` its position,
    ``n_reals[r] = 1``; idle lanes hold token 0 at position 0 against the
    scratch page); rows ``[n_decode:]`` are prefill chunk rows with
    ``n_reals[r]`` prompt tokens from ``q_starts[r]`` (``n_real == 0``: a
    pad row on scratch). pools: {plane: LOCAL pool}, updated in place;
    block_tables: token planes ``(n_layers, 1, R, pps_pad)``, state planes
    ``(n_layers, 1, R)`` int32 slots (the reference's (G, n_sub, R[, pps]));
    q_starts / n_reals: (R,) host integer arrays. ``impl``: ``"kernel"`` or
    ``"ref"``. Attention serves every row in one launch per layer; an RWKV
    layer runs the decode and chunk regions as two WKV launches.
    -> (logits (R, V) of each row's last real token, pools)
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    device = _device_of(pools)
    bt = _device_tables("serve_step_paged", block_tables, pools)
    tokens = torch.as_tensor(np.asarray(tokens)).to(device)
    R, Tc = tokens.shape
    qs = np.asarray(q_starts, np.int64).reshape(-1)
    nr = np.asarray(n_reals, np.int64).reshape(-1)

    x = embed(model.embed, cfg, tokens)
    if mixer_kind(cfg) == "rwkv":
        nr_dev = torch.as_tensor(nr).to(device)
        for layer, blk in enumerate(model.blocks):
            x = rwkv_mixed_paged(blk, cfg, x, pools, bt["wkv"][layer, 0],
                            bt["shift"][layer, 0], nr_dev, n_decode, impl)
    else:
        pool = pools["kv"]
        meta = attn.step_meta(qs, nr, n_decode, Tc, device)
        for layer, blk in enumerate(model.blocks):
            x = _layer(blk, cfg, x, lambda mix, h: attn.attention_mixed_paged(
                mix, cfg, h, pool, bt["kv"][layer, 0], qs, nr,
                n_decode=n_decode, read_pps=read_pps, impl=impl,
                meta=meta)[0])
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    last_idx = torch.as_tensor(np.clip(nr - 1, 0, Tc - 1)).to(device)
    last = x[torch.arange(R, device=device), last_idx]
    logits = unembed(model.embed, cfg, last)
    return logits, pools
