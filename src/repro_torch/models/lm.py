"""Decoder LM — the dense, MoE/MLA, VLM (a dense backbone whose prompts
open with prefix embedding rows), RWKV-6 and hybrid (Jamba) subset of
``repro/models/lm.py``: training, the paged serving runtime, and the dense
KV-cache path (``init_decode_state``, ``prefill``, ``decode_step``) that
also serves the windowed configs, which have no page plane.

The reference stacks layer groups for ``lax.scan``; here the model is an
``nn.Module`` whose ``blocks`` are one module per layer and the step is a
Python loop over them (PyTorch runs eagerly). Layer l is sub-layer
i = l % group_size of the reference's group g = l // group_size: one
sub-layer per group for the homogeneous families, six for gemma3 (five
local windowed layers, then a global one), eight for jamba (attention at
index 4, Mamba elsewhere, the MoE on odd indices). A sub-layer's kinds
depend only on i: its sequence mixer is attention (``"attn"``, or
``"attn_local"`` under a sliding window), MLA, Mamba (each followed by a
feed-forward: the MLP, or the MoE where ``ffn_kind`` says so) or RWKV-6
(time-mix and channel-mix, with their own residuals). See ``mixer_kind``
and ``ffn_kind``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (DENSE, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.core.device import resolve_device
from repro_torch.layers import attention as attn
from repro_torch.layers import mamba as mamba_mod
from repro_torch.layers import mla as mla_mod
from repro_torch.layers import rwkv6 as rwkv
from repro_torch.layers.core import (MLP, Embedding, RMSNorm, check_impl,
                                     embed, mlp, rms_norm, unembed,
                                     vocab_axis)
from repro_torch.layers.moe import MoE, moe_apply
from repro_torch.models.losses import shifted_xent


def group_size(cfg: ModelConfig) -> int:
    """Sub-layers per layer group: the hybrid's period, gemma3's
    ``global_layer_every``, else 1."""
    if cfg.family == HYBRID:
        return cfg.hybrid.period
    if cfg.global_layer_every > 0:
        return cfg.global_layer_every
    return 1


def n_groups(cfg: ModelConfig) -> int:
    gs = group_size(cfg)
    if cfg.n_layers % gs:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is no whole "
                         f"number of groups of {gs}")
    return cfg.n_layers // gs


def mixer_kind(cfg: ModelConfig, i: int = 0) -> str:
    """Sequence mixer of sub-layer i (the position within its group):
    ``"rwkv"``, ``"mamba"``, ``"mla"``, ``"attn"`` or ``"attn_local"``
    (attention under the sliding window)."""
    if cfg.family == SSM:
        return "rwkv"
    if cfg.family == HYBRID:
        return "attn" if i == cfg.hybrid.attn_index else "mamba"
    if cfg.mla is not None:
        return "mla"
    if cfg.global_layer_every > 0:
        return ("attn" if (i + 1) % cfg.global_layer_every == 0
                else "attn_local")
    return "attn_local" if cfg.sliding_window > 0 else "attn"


def ffn_kind(cfg: ModelConfig, i: int = 0) -> Optional[str]:
    """Feed-forward of sub-layer i: ``"moe"`` where
    ``i % moe_every == moe_every - 1``, else ``"mlp"``; None for RWKV-6
    (the channel-mix lives inside its block)."""
    if cfg.family == SSM:
        return None
    if cfg.moe is not None and (i % cfg.moe.moe_every
                                == cfg.moe.moe_every - 1):
        return "moe"
    return "mlp"


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Sub-layer i's attention window: the config's for ``"attn_local"``,
    else 0 (none)."""
    return cfg.sliding_window if mixer_kind(cfg, i) == "attn_local" else 0


def sublayers(cfg: ModelConfig) -> List[Tuple[int, int, str]]:
    """(g, j, kind) of every layer in order: its group g, its mixer kind,
    and j, its index among the sub-layers of that kind in the group (the
    reference's per-plane ``idx`` counter): block tables are indexed
    ``[g, j]``."""
    gs, out = group_size(cfg), []
    for layer in range(cfg.n_layers):
        g, i = divmod(layer, gs)
        kind = mixer_kind(cfg, i)
        j = sum(1 for k in range(i) if mixer_kind(cfg, k) == kind)
        out.append((g, j, kind))
    return out


def ffn_apply(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """A layer's feed-forward on the normed stream: the dropless MoE or the
    dense MLP."""
    if isinstance(p, MoE):
        return moe_apply(p, cfg, h, dropless=True)[0]
    return mlp(p, cfg, h)


class Block(nn.Module):
    """One pre-norm layer, sub-layer ``i`` of its group: ``n1``, ``mix``
    (attention, MLA, Mamba or RWKV), ``n2`` and, after attention, MLA or
    Mamba, ``ffn`` (MLP or MoE)."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None, i: int = 0):
        super().__init__()
        dt = cfg.dtype()
        self.n1 = RMSNorm(cfg.d_model, dt, device)
        self.n2 = RMSNorm(cfg.d_model, dt, device)
        kind = mixer_kind(cfg, i)
        if kind == "rwkv":
            # the channel-mix is the RWKV block's feed-forward
            self.mix = rwkv.RWKV(cfg, device, generator)
            self.ffn = None
            return
        mixer = {"mla": mla_mod.MLA, "mamba": mamba_mod.Mamba}.get(
            kind, attn.Attention)
        self.mix = mixer(cfg, device, generator)
        self.ffn = (MoE(cfg, device, generator) if ffn_kind(cfg, i) == "moe"
                    else MLP(cfg, device, generator))


class LM(nn.Module):
    """Weights of a decoder LM under the reference's names: ``embed.tok``
    (and ``embed.head`` when untied), ``blocks[l].{n1, mix, n2, ffn}``,
    ``final_norm``. Any config of the ported families builds; the paged
    entry points and the engine refuse those that are not paged-servable
    (``supports_paged``)."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in (DENSE, MOE, VLM, SSM, HYBRID):
            raise NotImplementedError(f"{cfg.name}: the {cfg.family} family "
                                      "is not a decoder-only LM (its model "
                                      "is models/encdec.py)")
        if cfg.attn_logit_softcap > 0:
            raise NotImplementedError(f"{cfg.name}: an attention logit "
                                      "softcap is not ported")
        self.embed = Embedding(cfg, device, generator)
        gs = group_size(cfg)
        self.blocks = nn.ModuleList(Block(cfg, device, generator, l % gs)
                                    for l in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype(), device)
        self.cfg = cfg


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random weights with the reference's keys, shapes and init scales
    (trunc-normal, 1/sqrt(d_in) linears, 0.02 embeddings and LoRAs, zero
    biases, norm scales and token-shift mixes, RWKV decay base -6, Mamba
    conv 0.5, dt bias -4.6, A = 1..d_state, D = 1), drawn
    from ``generator`` on ``device`` (CUDA unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, weights on "
                         f"{device}")
    return LM(cfg, device, generator)


def param_specs(cfg: ModelConfig) -> LM:
    """The model on the ``meta`` device, the counterpart of the
    reference's ``jax.eval_shape`` of ``init_params``: every parameter's
    shape and dtype, no storage."""
    return LM(cfg, torch.device("meta"))


def supports_paged(cfg: ModelConfig) -> bool:
    """True for the families whose whole dynamic context the port keeps on
    pages: dense, MoE or VLM stacks of full (unwindowed, uncapped) GQA/MQA
    attention or of MLA, RWKV-6 (its wkv and token-shift state) and the
    hybrid (Mamba ssm and conv state beside attention K/V). A VLM's prefix
    embedding rows are prompt positions like any other: their K/V lands
    on the ``kv`` plane."""
    if cfg.attn_logit_softcap > 0:
        return False
    if cfg.family == SSM:
        return cfg.ssm is not None
    if cfg.family == HYBRID and (cfg.hybrid is None or cfg.ssm is None):
        return False
    return (cfg.family in (DENSE, MOE, VLM, HYBRID)
            and cfg.sliding_window == 0 and cfg.global_layer_every == 0)


def paged_layout(cfg: ModelConfig) -> dict:
    """Map every dynamic-context leaf of the family onto a page PLANE.

    Every sub-layer position of a group contributes its state leaves to the
    planes below, in group order (so jamba's planes are ``ssm``, ``conv``,
    then ``kv``). Two plane kinds: ``tokens`` grows with context,
    ``ceil(ctx/page)`` pages per layer (``kv``: payload ``(2, n_kv, page,
    hd)``, attention K/V; ``mla``: payload ``(page, kv_lora + rope_dim)``,
    the fused MLA latent and roped key); ``state`` is fixed-size recurrent
    state, ONE page per layer whose payload is exactly the leaf (``ssm``:
    ``(di, ds)`` float32; ``conv``: ``(d_conv-1, di)`` native; ``wkv``:
    ``(H, hd, hd)`` float32; ``shift``: ``(2, d_model)`` native, rows
    time-mix / channel-mix shifts). Token planes are shareable across
    requests with a common prompt prefix; state planes are not.

    Returns ``{name: {"kind", "positions", "dtype", "shareable", ...}}``
    where token planes carry ``dims`` + ``token_bytes`` and state planes
    carry ``shape``.
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    native = cfg.torch_compute_dtype()
    itemsize = torch.empty((), dtype=native).element_size()
    planes: dict = {}

    def add(name, i, **kw):
        planes.setdefault(name, dict(positions=[], **kw))["positions"].append(
            i)

    for i in range(group_size(cfg)):
        kind = mixer_kind(cfg, i)
        if kind == "attn":
            K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
            add("kv", i, kind="tokens", dtype=native, dims=(K, hd),
                token_bytes=2 * K * hd * itemsize, shareable=True)
        elif kind == "mla":
            C = mla_mod.latent_dim(cfg)
            add("mla", i, kind="tokens", dtype=native, dims=(C,),
                token_bytes=C * itemsize, shareable=True)
        elif kind == "mamba":
            di, ds, dc, _ = mamba_mod._dims(cfg)
            add("ssm", i, kind="state", dtype=torch.float32, shape=(di, ds),
                shareable=False)
            add("conv", i, kind="state", dtype=native, shape=(dc - 1, di),
                shareable=False)
        else:
            rhd = cfg.ssm.rwkv_head_dim
            H = cfg.d_model // rhd
            add("wkv", i, kind="state", dtype=torch.float32,
                shape=(H, rhd, rhd), shareable=False)
            add("shift", i, kind="state", dtype=native,
                shape=(2, cfg.d_model), shareable=False)
    return planes


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
    """One pre-norm attention or MLA layer; ``attend(mix, h) -> out`` runs
    the mixer. The feed-forward (MLP or dropless MoE) runs over every
    token, pads included."""
    x = x + attend(blk.mix, rms_norm(blk.n1, x, cfg.rmsnorm_eps))
    return x + ffn_apply(blk.ffn, cfg, rms_norm(blk.n2, x, cfg.rmsnorm_eps))


def embed_rows(model: LM, cfg: ModelConfig, tokens: torch.Tensor, q_starts,
               prefix_embeds=None) -> torch.Tensor:
    """The residual stream's first rows: the token embeddings of tokens
    (R, Tc), except that a row's token at absolute position
    ``q_starts[r] + t < P`` takes row ``q_starts[r] + t`` of its prefix
    block ``prefix_embeds[r]`` (R, P, d) instead (cast to the compute
    dtype), as the reference's ``prefill_chunk_paged`` /
    ``serve_step_paged`` do. The prefix blocks stay on the device; the
    positions are host integers, and a step none of whose tokens lies below
    P reads no prefix at all."""
    x = embed(model.embed, cfg, tokens)
    if prefix_embeds is None:
        return x
    R, Tc = tokens.shape
    P = prefix_embeds.shape[1]
    rows = (np.asarray(q_starts, np.int64).reshape(-1, 1)
            + np.arange(Tc, dtype=np.int64)[None, :])
    under = rows < P
    if not under.any():
        return x
    if tuple(prefix_embeds.shape) != (R, P, cfg.d_model):
        raise ValueError(f"prefix_embeds {tuple(prefix_embeds.shape)} is not "
                         f"({R}, P, {cfg.d_model})")
    idx = torch.as_tensor(np.clip(rows, 0, P - 1)).to(x.device)
    pre = torch.gather(prefix_embeds.to(x.device), 1,
                       idx[:, :, None].expand(R, Tc, cfg.d_model))
    return torch.where(torch.as_tensor(under).to(x.device)[:, :, None],
                       pre.to(x.dtype), x)


def _tokens_on(tokens, device) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(np.asarray(tokens))
    return tokens.to(device)


def _train_group(blocks, cfg: ModelConfig, x, impl: str, shard_axes=None,
                 sp: bool = False):
    """One layer group of the training forward (the reference's
    ``_group_train``): each sub-layer by its kinds, RWKV-6 and Mamba from a
    zero state, attention through ``attention_full`` under the sub-layer's
    window (the flash op for ``impl="kernel"``), MLA through ``mla_full``,
    then the MLP or the MoE with capacity dispatch. With ``shard_axes``
    (the partitioned train step) the rank's shards: RWKV-6 through
    ``rwkv_train_sharded`` (the key-slice WKV and its backward),
    attention through ``attention_train_sharded``, MLA through
    ``mla_train_sharded``, Mamba through ``mamba_train_sharded``, the split
    MLP, the expert-parallel MoE; with ``sp`` the stream x is the rank's
    block of the positions, normed there (an RWKV-6 sub-layer gathers it
    whole). -> (x, the group's summed MoE aux loss)."""
    rank = shard_axes["ctx"] if shard_axes else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    B = x.shape[0]
    own = rank if sp else None
    for i, blk in enumerate(blocks):
        kind = mixer_kind(cfg, i)
        if kind == "rwkv" and rank is not None:
            x = rwkv.rwkv_train_sharded(blk.mix, cfg, x,
                                        {"n1": blk.n1, "n2": blk.n2},
                                        shard_axes, sp=sp, impl=impl)
            continue
        if kind == "rwkv":
            st = rwkv.init_rwkv_state(cfg, B, x.dtype, x.device)
            x, _ = rwkv.rwkv_block(blk.mix, cfg, x, st,
                                   {"n1": blk.n1, "n2": blk.n2}, impl=impl)
            continue
        h = rms_norm(blk.n1, x, cfg.rmsnorm_eps, own)
        if kind == "mamba" and rank is not None:
            h = mamba_mod.mamba_train_sharded(blk.mix, cfg, h, shard_axes,
                                              sp=sp)
        elif kind == "mamba":
            st = mamba_mod.init_mamba_state(cfg, B, x.dtype, x.device)
            h, _ = mamba_mod.mamba_forward(blk.mix, cfg, h, st)
        elif kind == "mla" and rank is not None:
            h = mla_mod.mla_train_sharded(blk.mix, cfg, h, rank, sp=sp)
        elif kind == "mla":
            h = mla_mod.mla_full(blk.mix, cfg, h)
        elif rank is not None:
            h = attn.attention_train_sharded(
                blk.mix, cfg, h, rank, window=layer_window(cfg, i), sp=sp,
                impl=impl)
        else:
            h = attn.attention_full(blk.mix, cfg, h,
                                    window=layer_window(cfg, i), impl=impl)
        x = x + h
        h = rms_norm(blk.n2, x, cfg.rmsnorm_eps, own)
        if isinstance(blk.ffn, MoE):
            h, a = moe_apply(blk.ffn, cfg, h, dropless=False,
                             shard_axes=shard_axes, sp=sp)
            aux = aux + a
        else:
            h = mlp(blk.ffn, cfg, h, rank, sp)
        x = x + h
    return x, aux


def seq_parallel(T: int, shard_axes) -> bool:
    """The reference's ``_sp_constrain`` rule: the residual stream of T
    positions is split along T over ``model`` between layer groups where
    ``shard_axes`` asks for it (``"sp"``) and ``T % model == 0``, ``T >=
    model``; else it stays replicated."""
    if not shard_axes or not shard_axes.get("sp"):
        return False
    n = shard_axes["ctx"].model_n
    return T % n == 0 and T >= n


def forward(model: LM, cfg: ModelConfig, tokens, *, prefix_embeds=None,
            remat: bool = False, impl: str = "kernel", shard_axes=None):
    """Training forward (the reference's ``forward`` and ``_group_train``):
    tokens (B,T), and for a VLM ``prefix_embeds`` (B,P,d) put before them
    in the compute dtype -> (logits (B,P+T,V), the MoE aux loss summed over
    layers, float32). Both move to the model's device. ``remat``
    recomputes each layer group (one layer; a hybrid's period) in the
    backward (``torch.utils.checkpoint``, the counterpart of
    ``jax.checkpoint`` of the group body).

    ``shard_axes`` (the reference's ``{"dp", "tp", "mesh", "sp"}`` plus
    ``"ctx"``, the rank's ``RankContext``): the partitioned train step on
    one rank, ``model`` and the inputs the rank's shards and rows. The
    stream is split along T over ``model`` between groups where
    ``seq_parallel`` says so (entering as the rank's block of the
    embeddings, ``ctx.split``). The logits are the rank's: its vocabulary
    slice over every position where the unembedding's spec splits the
    vocabulary (the final stream all-gathered along T, or entering the
    rank's work), else, under sequence parallelism, every logit of its
    block of the positions, else all of them."""
    rank = shard_axes["ctx"] if shard_axes else None
    device = model.embed.tok.device
    tokens = _tokens_on(tokens, device)
    x = embed(model.embed, cfg, tokens, rank)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(device=device, dtype=x.dtype), x],
                      dim=1)
    sp = seq_parallel(x.shape[1], shard_axes)
    if sp:
        x = rank.split(x, 1, "model")
    aux = torch.zeros((), dtype=torch.float32, device=device)
    gs = group_size(cfg)
    for g in range(n_groups(cfg)):
        blocks = model.blocks[g * gs:(g + 1) * gs]
        if remat:
            x, a = checkpoint(_train_group, blocks, cfg, x, impl, shard_axes,
                              sp, use_reentrant=False)
        else:
            x, a = _train_group(blocks, cfg, x, impl, shard_axes, sp)
        aux = aux + a
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps, rank if sp else None)
    if rank is None:
        return unembed(model.embed, cfg, x), aux
    if vocab_axis(model.embed) is None:
        # the whole vocabulary: the rank's positions, or all of them alike
        return unembed(model.embed, cfg, x, rank, local=sp), aux
    x = rank.all_gather(x, 1, "model") if sp else rank.enter(x)
    return unembed(model.embed, cfg, x, rank, local=True), aux


def loss_fn(model: LM, cfg: ModelConfig, batch: dict, *,
            remat: bool = False, impl: str = "kernel", shard_axes=None):
    """Next-token cross-entropy of ``batch["tokens"]`` (B,T) over the text
    positions (after ``batch["prefix_embeds"]``, when present), plus
    ``aux_loss_coef x aux / max(n_layers // moe_every, 1)`` for a MoE
    family -> float32 scalar. ``shard_axes``: the rank's loss in the
    partitioned train step (its rows' mean, the same on every rank of its
    ``model`` group), through the vocab-parallel or position-split
    ``shifted_xent``."""
    tokens = _tokens_on(batch["tokens"], model.embed.tok.device)
    prefix = batch.get("prefix_embeds")
    logits, aux = forward(model, cfg, tokens, prefix_embeds=prefix,
                          remat=remat, impl=impl, shard_axes=shard_axes)
    P = 0 if prefix is None else prefix.shape[1]
    vocab = vocab_axis(model.embed) if shard_axes else None
    if vocab is not None:
        loss = shifted_xent(logits[:, P:], tokens, {
            "ctx": shard_axes["ctx"], "vocab": vocab})
    elif seq_parallel(P + tokens.shape[1], shard_axes):
        loss = shifted_xent(logits, tokens, {
            "ctx": shard_axes["ctx"], "seq": "model", "prefix": P})
    else:
        loss = shifted_xent(logits[:, P:], tokens)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_coef * aux / max(
            cfg.n_layers // cfg.moe.moe_every, 1)
    return loss


def _sublayer_cache(cfg: ModelConfig, i: int, batch: int, seq: int, dtype,
                    device):
    kind = mixer_kind(cfg, i)
    if kind == "rwkv":
        return rwkv.init_rwkv_state(cfg, batch, dtype, device)
    if kind == "mamba":
        return mamba_mod.init_mamba_state(cfg, batch, dtype, device)
    if kind == "mla":
        return mla_mod.make_mla_cache(cfg, batch, seq, dtype, device)
    return attn.make_kv_cache(cfg, batch, seq, layer_window(cfg, i), dtype,
                              device)


def init_decode_state(cfg: ModelConfig, batch: int, seq: int, dtype=None,
                      device=None) -> dict:
    """The dense decode cache in the reference's layout: ``{"sub{i}":
    cache}`` per sub-layer position i of a group, each leaf stacked over
    the groups (leading axis G). Attention: ``KVCache`` (G, B, slots, K,
    hd), ``seq`` slots, ``min(window, seq)`` for a windowed layer's ring;
    MLA: ``MLACache`` (G, B, seq, *); RWKV-6: ``RWKVState`` (wkv float32);
    Mamba: ``MambaState`` (ssm float32). Zeros in ``dtype`` (the compute
    dtype by default) on ``device`` (CUDA unless the caller passes
    another; raises when CUDA is absent)."""
    device = resolve_device(device)
    dt = dtype or cfg.torch_compute_dtype()
    G = n_groups(cfg)
    state = {}
    for i in range(group_size(cfg)):
        shapes = _sublayer_cache(cfg, i, batch, seq, dt, "meta")
        state[f"sub{i}"] = type(shapes)(*(
            torch.zeros((G,) + t.shape, dtype=t.dtype, device=device)
            for t in shapes))
    return state


def decode_state_specs(cfg: ModelConfig, batch: int, seq: int,
                       dtype=None) -> dict:
    """``init_decode_state``'s tree on the ``meta`` device."""
    return init_decode_state(cfg, batch, seq, dtype, device="meta")


def _at(cache, g: int):
    """Group g's views of a stacked per-kind cache."""
    return type(cache)(*(t[g] for t in cache))


def _store(view, new):
    """Write a layer's new cache into its group views, where the layer did
    not write them in place."""
    for dst, src in zip(view, new):
        if src is not dst:
            dst.copy_(src)


def _view_specs(cache):
    """A stacked per-kind cache's leaf specs without the group entry: the
    specs of ``_at``'s views."""
    return type(cache)(*(t.pspec[1:] for t in cache))


def _group_prefill(blocks, cfg: ModelConfig, x, cache: dict, g: int,
                   impl: str, shard_axes=None):
    """One layer group over the whole prompt (the reference's
    ``_group_prefill``), filling group g of ``cache`` in place: attention
    through ``attention_full(return_kv=True)`` under the sub-layer's
    window (the flash op for ``impl="kernel"``) then ``fill_kv_cache``,
    MLA through ``mla_full(return_cache=True)``, RWKV-6 and Mamba from the
    cache's state, then the MLP or the MoE with capacity dispatch. With
    ``shard_axes`` the blocks and cache are a rank's shards: attention by
    ``attention_prefill_sharded`` on the route its cache's spec picks, MLA
    by ``mla_prefill_sharded``, RWKV-6 by ``rwkv_block_sharded`` (the
    key-slice WKV), Mamba by ``mamba_sharded``, the MLP split, the MoE
    expert-parallel."""
    rank = shard_axes["ctx"] if shard_axes else None
    for i, blk in enumerate(blocks):
        kind = mixer_kind(cfg, i)
        c = _at(cache[f"sub{i}"], g)
        specs = None if rank is None else _view_specs(cache[f"sub{i}"])
        if kind == "rwkv":
            norms = {"n1": blk.n1, "n2": blk.n2}
            if rank is None:
                x, nc = rwkv.rwkv_block(blk.mix, cfg, x, c, norms, impl=impl)
            else:
                x, nc = rwkv.rwkv_block_sharded(blk.mix, cfg, x, c, norms,
                                                specs, rank, impl=impl)
            _store(c, nc)
            continue
        h = rms_norm(blk.n1, x, cfg.rmsnorm_eps)
        if kind == "mamba":
            h, nc = (mamba_mod.mamba_forward(blk.mix, cfg, h, c)
                     if rank is None else
                     mamba_mod.mamba_sharded(blk.mix, cfg, h, c, specs, rank))
        elif kind == "mla" and rank is not None:
            h = mla_mod.mla_prefill_sharded(blk.mix, cfg, h, c, specs, rank)
            nc = c
        elif kind == "mla":
            h, (c_kv, k_rope) = mla_mod.mla_full(blk.mix, cfg, h,
                                                 return_cache=True)
            nc = mla_mod.fill_mla_cache(c, c_kv, k_rope)
        elif rank is not None:
            h = attn.attention_prefill_sharded(
                blk.mix, cfg, h, c, window=layer_window(cfg, i),
                spec=cache[f"sub{i}"].k.pspec, rank=rank, impl=impl)
            nc = c
        else:
            w = layer_window(cfg, i)
            h, (k, v) = attn.attention_full(blk.mix, cfg, h, window=w,
                                            return_kv=True, impl=impl)
            nc = attn.fill_kv_cache(c, k, v, w)
        _store(c, nc)
        x = x + h
        h = rms_norm(blk.n2, x, cfg.rmsnorm_eps)
        if isinstance(blk.ffn, MoE):
            h = moe_apply(blk.ffn, cfg, h, dropless=False,
                          shard_axes=shard_axes)[0]
        else:
            h = mlp(blk.ffn, cfg, h, rank)
        x = x + h
    return x


@torch.no_grad()
def prefill(model: LM, cfg: ModelConfig, tokens, cache: dict, *,
            prefix_embeds=None, impl: str = "kernel", shard_axes=None):
    """tokens (B,T) (a VLM's ``prefix_embeds`` (B,P,d) before them, at
    positions [0, P)) and an empty cache from ``init_decode_state`` ->
    (the last position's logits (B,V), the cache, filled in place). Every
    family, windowed attention included.

    ``shard_axes`` (the reference's ``{"dp", "tp", "mesh"}`` plus
    ``"ctx"``, the rank's ``RankContext``): the partitioned step on one
    rank of a mesh. ``model``, ``cache`` and the inputs are then the
    rank's shards (``partition.shard_model`` / ``shard_cache`` /
    ``shard_batch``), and the logits the rank's rows over the whole
    vocabulary."""
    check_impl(impl)
    rank = shard_axes["ctx"] if shard_axes else None
    device = model.embed.tok.device
    x = embed(model.embed, cfg, _tokens_on(tokens, device), rank)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(device=device, dtype=x.dtype), x],
                      dim=1)
    gs = group_size(cfg)
    for g in range(n_groups(cfg)):
        x = _group_prefill(model.blocks[g * gs:(g + 1) * gs], cfg, x, cache,
                           g, impl, shard_axes)
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    return unembed(model.embed, cfg, x[:, -1], rank), cache


def _group_decode(blocks, cfg: ModelConfig, x, cache: dict, g: int, pos,
                  impl: str, shard_axes=None):
    """One layer group for one token a lane (the reference's
    ``_group_decode``), updating group g of ``cache`` in place: attention
    through ``attention_decode`` (a ring for a windowed layer), MLA through
    the absorbed ``mla_decode``, RWKV-6 (the WKV op for
    ``impl="kernel"``) and Mamba one step from the cache's state, then the
    MLP or the dropless MoE. With ``shard_axes``, a rank's shards:
    ``attention_decode_sharded``, ``mla_decode_sharded``,
    ``rwkv_block_sharded``, ``mamba_sharded``, the MLP split, the MoE
    expert-parallel."""
    rank = shard_axes["ctx"] if shard_axes else None
    for i, blk in enumerate(blocks):
        kind = mixer_kind(cfg, i)
        c = _at(cache[f"sub{i}"], g)
        specs = None if rank is None else _view_specs(cache[f"sub{i}"])
        if kind == "rwkv":
            norms = {"n1": blk.n1, "n2": blk.n2}
            if rank is None:
                x, nc = rwkv.rwkv_block(blk.mix, cfg, x, c, norms, impl=impl)
            else:
                x, nc = rwkv.rwkv_block_sharded(blk.mix, cfg, x, c, norms,
                                                specs, rank, impl=impl)
            _store(c, nc)
            continue
        h = rms_norm(blk.n1, x, cfg.rmsnorm_eps)
        if kind == "mamba":
            h, nc = (mamba_mod.mamba_decode(blk.mix, cfg, h, c)
                     if rank is None else
                     mamba_mod.mamba_sharded(blk.mix, cfg, h, c, specs, rank,
                                             decode=True))
        elif kind == "mla" and rank is not None:
            h = mla_mod.mla_decode_sharded(blk.mix, cfg, h, c, pos, specs,
                                           rank)
            nc = c
        elif kind == "mla":
            h, nc = mla_mod.mla_decode(blk.mix, cfg, h, c, pos)
        elif rank is not None:
            h = attn.attention_decode_sharded(
                blk.mix, cfg, h, c, pos, window=layer_window(cfg, i),
                spec=cache[f"sub{i}"].k.pspec, rank=rank)
            nc = c
        else:
            h, nc = attn.attention_decode(blk.mix, cfg, h, c, pos,
                                          window=layer_window(cfg, i))
        _store(c, nc)
        x = x + h
        h = rms_norm(blk.n2, x, cfg.rmsnorm_eps)
        if rank is None:
            x = x + ffn_apply(blk.ffn, cfg, h)
        elif isinstance(blk.ffn, MoE):
            x = x + moe_apply(blk.ffn, cfg, h, dropless=True,
                              shard_axes=shard_axes)[0]
        else:
            x = x + mlp(blk.ffn, cfg, h, rank)
    return x


@torch.no_grad()
def decode_step(model: LM, cfg: ModelConfig, cache: dict, tokens, pos, *,
                impl: str = "kernel", shard_axes=None):
    """One token for every sequence: tokens (B,), pos (B,) (host ints or
    tensors; a scalar pos is every lane's) -> (logits (B,V), the cache,
    updated in place). ``shard_axes``: the partitioned step on one rank,
    as ``prefill`` takes it."""
    check_impl(impl)
    rank = shard_axes["ctx"] if shard_axes else None
    device = model.embed.tok.device
    tokens = _tokens_on(tokens, device).reshape(-1, 1)
    pos = _tokens_on(pos, device).reshape(-1).long()
    x = embed(model.embed, cfg, tokens, rank)
    gs = group_size(cfg)
    for g in range(n_groups(cfg)):
        x = _group_decode(model.blocks[g * gs:(g + 1) * gs], cfg, x, cache,
                          g, pos, impl, shard_axes)
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    return unembed(model.embed, cfg, x[:, 0], rank), cache


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


def _mamba_mix(p, cfg: ModelConfig, h, pools: dict, ss, cs, *,
               n_real=None, decode: bool = False):
    """One Mamba mixer against the state pools: the lanes' ssm and conv
    pages at slots ``ss`` / ``cs`` (B,) are read, carried through
    ``mamba_forward`` (or ``mamba_decode``) and written back in place.
    Returns the mixer's output (B,T,d). Lanes sharing a slot (idle lanes on
    scratch) write it in an undefined order."""
    st = mamba_mod.MambaState(pools["ssm"][ss.long()],
                              pools["conv"][cs.long()])
    if decode:
        out, nst = mamba_mod.mamba_decode(p, cfg, h, st)
    else:
        out, nst = mamba_mod.mamba_forward(p, cfg, h, st, n_real=n_real)
    pools["ssm"][ss.long()] = nst.ssm
    pools["conv"][cs.long()] = nst.conv.to(pools["conv"].dtype)
    return out


def mamba_mixed_paged(p, cfg: ModelConfig, h, pools, ss, cs, nr,
                      n_decode: int):
    """A Mamba mixer of a packed step, run as two row regions (the
    reference's ``_group_fwd_mixed``): the decode lanes' single tokens
    through ``mamba_decode``, their output padded with zeros to Tc, then
    the chunk rows through ``mamba_forward`` with their per-row
    ``n_real``."""
    R, Tc, d = h.shape
    parts = []
    if n_decode:
        h_dec = _mamba_mix(p, cfg, h[:n_decode, :1], pools, ss[:n_decode],
                           cs[:n_decode], decode=True)
        if Tc > 1:
            h_dec = torch.cat([h_dec, h_dec.new_zeros((n_decode, Tc - 1, d))],
                              dim=1)
        parts.append(h_dec)
    if R > n_decode:
        parts.append(_mamba_mix(p, cfg, h[n_decode:], pools, ss[n_decode:],
                                cs[n_decode:], n_real=nr[n_decode:]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _kinds(cfg: ModelConfig) -> set:
    return {kind for _, _, kind in sublayers(cfg)}


def _own_pages_only(cfg: ModelConfig, pools: dict) -> Optional[int]:
    """The page size when a chunk row's K/V must go only into the pages
    its tokens reach (``attn.step_meta``), else None: the row's padding
    goes where its table says, as in the reference. A family with a MoE
    takes the page size. On the card several rows' padding would land on
    the scratch page in no defined order; pad tokens read it, and a MoE
    layer's per-expert GEMMs, whose tiling follows the row counts that
    pad tokens' routing sets, would carry those values into real rows, so
    a step would not repeat bit for bit. A dense layer keeps each token's
    row to itself."""
    return pools["kv"].shape[3] if cfg.moe is not None else None


def prefill_chunk_paged(model: LM, cfg: ModelConfig, tokens, pools,
                        block_tables, q_start: int, last_index: int, *,
                        prefix_embeds=None, read_pps: Optional[int] = None,
                        impl: str = "kernel"):
    """Prefill ONE CHUNK of one request, writing its state straight into the
    page pools — any family, one code path.

    tokens: (1, Tc) int — the chunk, bucket-padded (attention rows past the
    real length are attended causally like any other and overwritten by
    later chunks or decode; for the recurrent planes ``n_real = last_index
    + 1`` makes the padding an identity transition); pools: {plane: LOCAL
    pool}, updated in place; block_tables: token planes
    ``(G, n_sub, pps_pad)`` int32 slots from position 0, scratch-padded,
    state planes ``(G, n_sub)`` bare slots
    (``PagedStateRuntime.block_tables_prefill``); q_start: the chunk's
    absolute start position; last_index: the row whose logits the caller
    wants. ``read_pps`` bounds the attention or MLA sweep. prefix_embeds:
    (1, P, d) VLM prefix rows on the device — the chunk's rows at absolute
    positions < P take them instead of the token embedding
    (``embed_rows``).
    -> (logits (1, V) of ``last_index``, pools)
    """
    check_impl(impl)
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    device = _device_of(pools)
    bt = _device_tables("prefill_chunk_paged", block_tables, pools)
    tokens = torch.as_tensor(np.asarray(tokens)).to(device)
    if tokens.shape[0] != 1:
        raise ValueError("chunked prefill is per-request")
    Tc = tokens.shape[1]
    n_real = int(last_index) + 1
    kinds = _kinds(cfg)
    a_meta = (attn.step_meta([q_start], [n_real], 0, Tc, device,
                             page=_own_pages_only(cfg, pools))
              if "attn" in kinds else None)
    m_meta = (mla_mod.step_meta([q_start], 0, Tc, pools["mla"].shape[1],
                                bt["mla"].shape[-1], device)
              if "mla" in kinds else None)
    x = embed_rows(model, cfg, tokens, [q_start], prefix_embeds)
    for blk, (g, j, kind) in zip(model.blocks, sublayers(cfg)):
        if kind == "rwkv":
            x = _rwkv_layer(blk, cfg, x, pools, bt["wkv"][g, j:j + 1],
                            bt["shift"][g, j:j + 1], impl=impl,
                            n_real=n_real)
        elif kind == "mamba":
            x = _layer(blk, cfg, x, lambda mix, h: _mamba_mix(
                mix, cfg, h, pools, bt["ssm"][g, j:j + 1],
                bt["conv"][g, j:j + 1], n_real=n_real))
        elif kind == "mla":
            x = _layer(blk, cfg, x, lambda mix, h: mla_mod.mla_prefill_chunk(
                mix, cfg, h, pools["mla"], bt["mla"][g, j], q_start,
                read_pps=read_pps, meta=m_meta)[0])
        else:
            x = _layer(blk, cfg, x, lambda mix, h: attn.attention_prefill_chunk(
                mix, cfg, h, pools["kv"], bt["kv"][g, j], q_start,
                read_pps=read_pps, impl=impl, meta=a_meta)[0])
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    logits = unembed(model.embed, cfg, x[:, int(last_index)])
    return logits, pools


def decode_step_paged(model: LM, cfg: ModelConfig, pools, block_tables,
                      tokens, pos, *, impl: str = "kernel"):
    """One token for every lane against the page pools.

    tokens / pos: (B,) host ints — each lane's next token and its position
    (idle lanes: token 0 at position 0 on scratch); pools: {plane: pool}
    updated in place; block_tables: token planes ``(G, n_sub, B, pps)``,
    state planes ``(G, n_sub, B)`` int32 LOCAL slots
    (``PagedStateRuntime.block_tables``).
    -> (logits (B, V), pools)
    """
    check_impl(impl)
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    device = _device_of(pools)
    bt = _device_tables("decode_step_paged", block_tables, pools)
    pos = np.asarray(pos, np.int64).reshape(-1)
    tokens = torch.as_tensor(np.asarray(tokens).reshape(-1, 1)).to(device)
    kinds = _kinds(cfg)
    a_meta = attn.decode_meta(pos, device) if "attn" in kinds else None
    m_meta = (mla_mod.step_meta(pos, len(pos), 1, pools["mla"].shape[1],
                                bt["mla"].shape[-1], device)
              if "mla" in kinds else None)
    x = embed(model.embed, cfg, tokens)
    for blk, (g, j, kind) in zip(model.blocks, sublayers(cfg)):
        if kind == "rwkv":
            x = _rwkv_layer(blk, cfg, x, pools, bt["wkv"][g, j],
                            bt["shift"][g, j], impl=impl)
        elif kind == "mamba":
            x = _layer(blk, cfg, x, lambda mix, h: _mamba_mix(
                mix, cfg, h, pools, bt["ssm"][g, j], bt["conv"][g, j],
                decode=True))
        elif kind == "mla":
            x = _layer(blk, cfg, x, lambda mix, h: mla_mod.mla_decode_paged(
                mix, cfg, h, pools["mla"], bt["mla"][g, j], pos,
                meta=m_meta)[0])
        else:
            x = _layer(blk, cfg, x, lambda mix, h: attn.attention_decode_paged(
                mix, cfg, h, pools["kv"], bt["kv"][g, j], pos, impl=impl,
                meta=a_meta)[0])
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
                     prefix_embeds=None, read_pps: Optional[int] = None,
                     impl: str = "kernel"):
    """ONE fused engine step: every scheduled decode token and every
    request's prompt chunk in a single call.

    tokens: (R, Tc) int packed rows. Rows ``[:n_decode]`` are decode lanes
    (the next token at column 0, ``q_starts[r]`` its position,
    ``n_reals[r] = 1``; idle lanes hold token 0 at position 0 against the
    scratch page); rows ``[n_decode:]`` are prefill chunk rows with
    ``n_reals[r]`` prompt tokens from ``q_starts[r]`` (``n_real == 0``: a
    pad row on scratch). pools: {plane: LOCAL pool}, updated in place;
    block_tables: token planes ``(G, n_sub, R, pps_pad)``, state planes
    ``(G, n_sub, R)`` int32 slots, table ``[g, j]`` the j-th sub-layer of
    that plane in group g; q_starts / n_reals: (R,) host integer arrays.
    prefix_embeds: (R, P, d) VLM prefix rows on the device (zeros for rows
    of no VLM request), or None: a row's tokens at absolute positions < P
    take their prefix row instead of the token embedding (``embed_rows``).
    ``impl``: ``"kernel"`` or ``"ref"``. Attention serves every row in one
    launch per layer; an RWKV layer runs the decode and chunk regions as
    two WKV launches; MLA and Mamba layers have no kernel (the reference's
    are ``jnp`` code), so ``impl`` selects nothing there: a Mamba layer
    runs its decode lanes through ``mamba_decode`` and its chunk rows
    through ``mamba_forward``; each MoE layer syncs with the host once.
    -> (logits (R, V) of each row's last real token, pools)
    """
    check_impl(impl)
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable by the port")
    device = _device_of(pools)
    bt = _device_tables("serve_step_paged", block_tables, pools)
    tokens = torch.as_tensor(np.asarray(tokens)).to(device)
    R, Tc = tokens.shape
    qs = np.asarray(q_starts, np.int64).reshape(-1)
    nr = np.asarray(n_reals, np.int64).reshape(-1)
    kinds = _kinds(cfg)
    nr_dev = (torch.as_tensor(nr).to(device)
              if kinds & {"rwkv", "mamba"} else None)
    a_meta = (attn.step_meta(qs, nr, n_decode, Tc, device,
                             page=_own_pages_only(cfg, pools))
              if "attn" in kinds else None)
    m_meta = (mla_mod.step_meta(qs, n_decode, Tc, pools["mla"].shape[1],
                                bt["mla"].shape[-1], device)
              if "mla" in kinds else None)
    x = embed_rows(model, cfg, tokens, qs, prefix_embeds)
    for blk, (g, j, kind) in zip(model.blocks, sublayers(cfg)):
        if kind == "rwkv":
            x = rwkv_mixed_paged(blk, cfg, x, pools, bt["wkv"][g, j],
                                 bt["shift"][g, j], nr_dev, n_decode, impl)
        elif kind == "mamba":
            x = _layer(blk, cfg, x, lambda mix, h: mamba_mixed_paged(
                mix, cfg, h, pools, bt["ssm"][g, j], bt["conv"][g, j],
                nr_dev, n_decode))
        elif kind == "mla":
            x = _layer(blk, cfg, x, lambda mix, h: mla_mod.mla_mixed_paged(
                mix, cfg, h, pools["mla"], bt["mla"][g, j], qs, nr,
                n_decode=n_decode, read_pps=read_pps, meta=m_meta)[0])
        else:
            x = _layer(blk, cfg, x, lambda mix, h: attn.attention_mixed_paged(
                mix, cfg, h, pools["kv"], bt["kv"][g, j], qs, nr,
                n_decode=n_decode, read_pps=read_pps, impl=impl,
                meta=a_meta)[0])
    x = rms_norm(model.final_norm, x, cfg.rmsnorm_eps)
    last_idx = torch.as_tensor(np.clip(nr - 1, 0, Tc - 1)).to(device)
    last = x[torch.arange(R, device=device), last_idx]
    logits = unembed(model.embed, cfg, last)
    return logits, pools
