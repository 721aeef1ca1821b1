"""Uniform model API (the part of ``repro/models/api.py`` the port runs):
the training loss and forward, and for the paged serving runtime the fused
engine step and the per-request chunked prefill and decode it is held
against."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def init_params(cfg: ModelConfig, generator, device=None):
    return lm.init_params(cfg, generator, device)


def forward(model, cfg: ModelConfig, tokens, *, remat: bool = False,
            impl: str = "kernel"):
    """tokens (B,T) -> (logits (B,T,V), aux)."""
    return lm.forward(model, cfg, tokens, remat=remat, impl=impl)


def loss_fn(model, cfg: ModelConfig, batch: dict, *, remat: bool = False,
            impl: str = "kernel"):
    """Next-token cross-entropy of ``batch["tokens"]``."""
    return lm.loss_fn(model, cfg, batch, remat=remat, impl=impl)


def supports_paged(cfg: ModelConfig) -> bool:
    return lm.supports_paged(cfg)


def paged_layout(cfg: ModelConfig) -> dict:
    return lm.paged_layout(cfg)


def prefill_chunk_paged(model, cfg: ModelConfig, tokens, pools, block_tables,
                        q_start: int, last_index: int, *, read_pps=None,
                        impl: str = "kernel"):
    """One bucket-padded prompt chunk of one request -> (logits (1,V) of
    ``last_index``, pools)."""
    return lm.prefill_chunk_paged(model, cfg, tokens, pools, block_tables,
                                  q_start, last_index, read_pps=read_pps,
                                  impl=impl)


def decode_step_paged(model, cfg: ModelConfig, pools, block_tables, tokens,
                      pos, *, impl: str = "kernel"):
    """One token for every decode lane -> (logits (B,V), pools)."""
    return lm.decode_step_paged(model, cfg, pools, block_tables, tokens, pos,
                                impl=impl)


def serve_step_paged(model, cfg: ModelConfig, tokens, pools, block_tables,
                     q_starts, n_reals, *, n_decode: int, read_pps=None,
                     impl: str = "kernel"):
    """One fused engine step: every decode lane and every request's prompt
    chunk packed into a (R, Tc) row batch -> (logits (R, V), pools)."""
    return lm.serve_step_paged(model, cfg, tokens, pools, block_tables,
                               q_starts, n_reals, n_decode=n_decode,
                               read_pps=read_pps, impl=impl)
