"""Uniform model API (the part of ``repro/models/api.py`` the port runs):
the training loss and forward, the dense KV-cache path (``init_decode_state``,
``prefill``, ``decode_step``), and for the paged serving runtime the fused
engine step and the per-request chunked prefill and decode it is held
against. The training and dense-cache entry points dispatch by family, as
the reference's ``model_module`` does: the encoder-decoder to
``models/encdec.py``, every other family to ``models/lm.py``.

For the dry run, ``param_specs``, ``decode_state_specs`` and
``make_inputs`` give every input of an (arch x shape) cell on the ``meta``
device (shapes and dtypes, no storage); ``instantiate`` turns such specs
into concrete tensors drawn as the reference's ``instantiate`` draws
them."""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ENCDEC, ModelConfig, ShapeConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import encdec, lm


def model_module(cfg: ModelConfig):
    return encdec if cfg.family == ENCDEC else lm


def init_params(cfg: ModelConfig, generator, device=None):
    return model_module(cfg).init_params(cfg, generator, device)


def param_specs(cfg: ModelConfig):
    """The model on the ``meta`` device: parameter shapes and dtypes, no
    storage."""
    return model_module(cfg).param_specs(cfg)


def forward(model, cfg: ModelConfig, tokens, *, prefix_embeds=None,
            enc_embeds=None, remat: bool = False, impl: str = "kernel",
            shard_axes=None):
    """tokens (B,T) (a VLM's ``prefix_embeds`` (B,P,d) before them; an
    encoder-decoder's ``enc_embeds`` (B,T_enc,d) for its encoder) ->
    (logits (B,P+T,V), aux). ``shard_axes``: one rank's partitioned
    forward (``lm.forward``, ``encdec.forward``), its logits the rank's."""
    if cfg.family == ENCDEC:
        return encdec.forward(model, cfg, tokens, enc_embeds, remat=remat,
                              impl=impl, shard_axes=shard_axes)
    return lm.forward(model, cfg, tokens, prefix_embeds=prefix_embeds,
                      remat=remat, impl=impl, shard_axes=shard_axes)


def loss_fn(model, cfg: ModelConfig, batch: dict, *, remat: bool = False,
            impl: str = "kernel", shard_axes=None):
    """Next-token cross-entropy of ``batch["tokens"]`` (after
    ``batch["prefix_embeds"]``, when present; given
    ``batch["enc_embeds"]`` for an encoder-decoder), plus the MoE aux
    term. ``shard_axes``: the rank's loss in the partitioned train step
    (``lm.loss_fn``, ``encdec.loss_fn``)."""
    return model_module(cfg).loss_fn(model, cfg, batch, remat=remat,
                                     impl=impl, shard_axes=shard_axes)


def init_decode_state(cfg: ModelConfig, batch: int, seq: int, dtype=None,
                      device=None) -> dict:
    """The stacked dense cache: ``{"sub{i}": per-kind cache}`` (windowed
    layers hold rings of ``min(window, seq)`` slots), an encoder-decoder's
    ``{"self", "cross"}``. CUDA unless the caller passes another
    device."""
    return model_module(cfg).init_decode_state(cfg, batch, seq, dtype,
                                               device)


def decode_state_specs(cfg: ModelConfig, batch: int, seq: int,
                       dtype=None) -> dict:
    """``init_decode_state``'s tree on the ``meta`` device."""
    return model_module(cfg).decode_state_specs(cfg, batch, seq, dtype)


def prefill(model, cfg: ModelConfig, tokens, cache, *, prefix_embeds=None,
            enc_embeds=None, impl: str = "kernel", shard_axes=None):
    """tokens (B,T) + an empty cache (+ an encoder-decoder's
    ``enc_embeds``) -> (last-token logits (B,V), the filled cache).
    ``shard_axes``: one rank's partitioned step (``lm.prefill``,
    ``encdec.prefill``)."""
    if cfg.family == ENCDEC:
        return encdec.prefill(model, cfg, tokens, cache,
                              enc_embeds=enc_embeds, impl=impl,
                              shard_axes=shard_axes)
    return lm.prefill(model, cfg, tokens, cache,
                      prefix_embeds=prefix_embeds, impl=impl,
                      shard_axes=shard_axes)


def decode_step(model, cfg: ModelConfig, cache, tokens, pos, *,
                impl: str = "kernel", shard_axes=None):
    """One token for every sequence. tokens (B,), pos (B,) -> (logits
    (B,V), the cache). ``shard_axes``: one rank's partitioned step
    (``lm.decode_step``, ``encdec.decode_step``)."""
    if cfg.family == ENCDEC:
        return encdec.decode_step(model, cfg, cache, tokens, pos, impl=impl,
                                  shard_axes=shard_axes)
    return lm.decode_step(model, cfg, cache, tokens, pos, impl=impl,
                          shard_axes=shard_axes)


def supports_paged(cfg: ModelConfig) -> bool:
    """The encoder-decoder's cross K/V has no page plane, so no engine
    serves it."""
    return cfg.family != ENCDEC and lm.supports_paged(cfg)


def paged_layout(cfg: ModelConfig) -> dict:
    return lm.paged_layout(cfg)


def prefill_chunk_paged(model, cfg: ModelConfig, tokens, pools, block_tables,
                        q_start: int, last_index: int, *, prefix_embeds=None,
                        read_pps=None, impl: str = "kernel"):
    """One bucket-padded prompt chunk of one request (a VLM's prefix rows
    from ``prefix_embeds`` (1, P, d)) -> (logits (1,V) of ``last_index``,
    pools)."""
    return lm.prefill_chunk_paged(model, cfg, tokens, pools, block_tables,
                                  q_start, last_index,
                                  prefix_embeds=prefix_embeds,
                                  read_pps=read_pps, impl=impl)


def decode_step_paged(model, cfg: ModelConfig, pools, block_tables, tokens,
                      pos, *, impl: str = "kernel"):
    """One token for every decode lane -> (logits (B,V), pools)."""
    return lm.decode_step_paged(model, cfg, pools, block_tables, tokens, pos,
                                impl=impl)


def serve_step_paged(model, cfg: ModelConfig, tokens, pools, block_tables,
                     q_starts, n_reals, *, n_decode: int, prefix_embeds=None,
                     read_pps=None, impl: str = "kernel"):
    """One fused engine step: every decode lane and every request's prompt
    chunk packed into a (R, Tc) row batch, a VLM's prefix rows from
    ``prefix_embeds`` (R, P, d) -> (logits (R, V), pools)."""
    return lm.serve_step_paged(model, cfg, tokens, pools, block_tables,
                               q_starts, n_reals, n_decode=n_decode,
                               prefix_embeds=prefix_embeds,
                               read_pps=read_pps, impl=impl)


# ---------------------------------------------------------------------------
# Inputs per (arch, shape)
# ---------------------------------------------------------------------------
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def make_inputs(cfg: ModelConfig, shape: ShapeConfig,
                batch_override: int = 0) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of this cell, under the
    reference's keys, shapes and dtypes.

    train:   {tokens, prefix_embeds?/enc_embeds?}
    prefill: {tokens, cache, prefix_embeds?/enc_embeds?}
    decode:  {tokens (B,), pos (B,), cache}
    """
    B = batch_override or shape.global_batch
    S = shape.seq_len
    dt = cfg.torch_compute_dtype()
    tok = torch.int32
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = _spec((B, S - cfg.n_prefix_embeds), tok)
        if cfg.n_prefix_embeds:
            out["prefix_embeds"] = _spec((B, cfg.n_prefix_embeds,
                                          cfg.d_model), dt)
        if cfg.family == ENCDEC:
            out["enc_embeds"] = _spec((B, cfg.encdec.encoder_seq_len,
                                       cfg.d_model), dt)
        if shape.kind == "prefill":
            out["cache"] = decode_state_specs(cfg, B, S)
    elif shape.kind == "decode":
        out["tokens"] = _spec((B,), tok)
        out["pos"] = _spec((B,), tok)
        out["cache"] = decode_state_specs(cfg, B, S)
    else:
        raise ValueError(shape.kind)
    return out


def tree_leaves(tree) -> list:
    """The tensors of a nest of dicts, lists, tuples and NamedTuples in the
    order ``jax.tree.flatten`` takes the reference's tree: a dict's keys
    sorted, sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _draw(rng, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """The reference's draw: integers in [0, 100), else normal x 0.02,
    cast to ``dtype``."""
    if dtype.is_floating_point:
        arr = rng.standard_normal(shape) * 0.02
    else:
        arr = rng.integers(0, 100, shape)
    return torch.from_numpy(np.asarray(arr)).to(dtype).to(device)


def reference_leaves(model) -> Dict[tuple, list]:
    """The reference's parameter tree as ``{path: [parameter names]}``: a
    layer's parameters are one leaf of the reference's stacked tree, whose
    leading axis runs over the groups (``blocks.sub{i}``, layer g x
    group_size + i) or the layers (``enc_blocks``, ``dec_blocks``), as
    ``params.from_jax`` maps them; every other parameter is a leaf of its
    own."""
    gs = lm.group_size(model.cfg) if model.cfg.family != ENCDEC else 0
    leaves: Dict[tuple, list] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            path = ("blocks", f"sub{int(parts[1]) % gs}", *parts[2:])
        elif parts[0] in ("enc_blocks", "dec_blocks"):
            path = (parts[0], *parts[2:])
        else:
            path = tuple(parts)
        leaves.setdefault(path, []).append(name)
    return leaves


def instantiate(specs, seed: int = 0, device=None):
    """Deterministic concrete tensors matching a spec tree (a model from
    ``param_specs``, or a nest of meta tensors such as ``make_inputs``
    gives), on ``device`` (CUDA unless the caller asks for another).

    The values are the reference's ``instantiate``: one
    ``numpy.random.default_rng(seed)`` draws the leaves in the order
    ``jax.tree.flatten`` takes the reference's tree (dict keys sorted), a
    model's parameters through ``reference_leaves`` (a stacked leaf is one
    draw of shape (G, ...), split over its layers). A model comes back as
    a copy, the specs are left as they are."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if isinstance(specs, torch.nn.Module):
        named = dict(specs.named_parameters())
        model = copy.deepcopy(specs).to_empty(device=device)
        params = dict(model.named_parameters())
        leaves = reference_leaves(specs)
        with torch.no_grad():
            for path in sorted(leaves):
                names = leaves[path]
                one = named[names[0]]
                stacked = path[0].endswith("blocks")
                shape = ((len(names),) if stacked else ()) + tuple(one.shape)
                vals = _draw(rng, shape, one.dtype, device)
                for g, name in enumerate(names):
                    params[name].copy_(vals[g] if stacked else vals)
        return model
    drawn = {id(t): _draw(rng, tuple(t.shape), t.dtype, device)
             for t in tree_leaves(specs)}
    return _tree_map(lambda t: drawn[id(t)], specs)
