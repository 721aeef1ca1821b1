"""Uniform model API (the part of ``repro/models/api.py`` the port runs):
the training loss and forward, the dense KV-cache path (``init_decode_state``,
``prefill``, ``decode_step``), and for the paged serving runtime the fused
engine step and the per-request chunked prefill and decode it is held
against. The training and dense-cache entry points dispatch by family, as
the reference's ``model_module`` does: the encoder-decoder to
``models/encdec.py``, every other family to ``models/lm.py``."""
from __future__ import annotations

from repro_torch.configs.base import ENCDEC, ModelConfig
from repro_torch.models import encdec, lm


def model_module(cfg: ModelConfig):
    return encdec if cfg.family == ENCDEC else lm


def init_params(cfg: ModelConfig, generator, device=None):
    return model_module(cfg).init_params(cfg, generator, device)


def forward(model, cfg: ModelConfig, tokens, *, prefix_embeds=None,
            enc_embeds=None, remat: bool = False, impl: str = "kernel"):
    """tokens (B,T) (a VLM's ``prefix_embeds`` (B,P,d) before them; an
    encoder-decoder's ``enc_embeds`` (B,T_enc,d) for its encoder) ->
    (logits (B,P+T,V), aux)."""
    if cfg.family == ENCDEC:
        return encdec.forward(model, cfg, tokens, enc_embeds, remat=remat,
                              impl=impl)
    return lm.forward(model, cfg, tokens, prefix_embeds=prefix_embeds,
                      remat=remat, impl=impl)


def loss_fn(model, cfg: ModelConfig, batch: dict, *, remat: bool = False,
            impl: str = "kernel"):
    """Next-token cross-entropy of ``batch["tokens"]`` (after
    ``batch["prefix_embeds"]``, when present; given
    ``batch["enc_embeds"]`` for an encoder-decoder), plus the MoE aux
    term."""
    return model_module(cfg).loss_fn(model, cfg, batch, remat=remat,
                                     impl=impl)


def init_decode_state(cfg: ModelConfig, batch: int, seq: int, dtype=None,
                      device=None) -> dict:
    """The stacked dense cache: ``{"sub{i}": per-kind cache}`` (windowed
    layers hold rings of ``min(window, seq)`` slots), an encoder-decoder's
    ``{"self", "cross"}``. CUDA unless the caller passes another
    device."""
    return model_module(cfg).init_decode_state(cfg, batch, seq, dtype,
                                               device)


def prefill(model, cfg: ModelConfig, tokens, cache, *, prefix_embeds=None,
            enc_embeds=None, impl: str = "kernel"):
    """tokens (B,T) + an empty cache (+ an encoder-decoder's
    ``enc_embeds``) -> (last-token logits (B,V), the filled cache)."""
    if cfg.family == ENCDEC:
        return encdec.prefill(model, cfg, tokens, cache,
                              enc_embeds=enc_embeds, impl=impl)
    return lm.prefill(model, cfg, tokens, cache,
                      prefix_embeds=prefix_embeds, impl=impl)


def decode_step(model, cfg: ModelConfig, cache, tokens, pos, *,
                impl: str = "kernel"):
    """One token for every sequence. tokens (B,), pos (B,) -> (logits
    (B,V), the cache)."""
    return model_module(cfg).decode_step(model, cfg, cache, tokens, pos,
                                         impl=impl)


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
