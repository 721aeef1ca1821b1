"""Uniform model API of the paged serving runtime (the part of
``repro/models/api.py`` the fused engine step calls)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def supports_paged(cfg: ModelConfig) -> bool:
    return lm.supports_paged(cfg)


def paged_layout(cfg: ModelConfig) -> dict:
    return lm.paged_layout(cfg)


def serve_step_paged(model, cfg: ModelConfig, tokens, pools, block_tables,
                     q_starts, n_reals, *, n_decode: int, read_pps=None,
                     impl: str = "kernel"):
    """One fused engine step: every decode lane and every request's prompt
    chunk packed into a (R, Tc) row batch, one attention launch per layer
    -> (logits (R, V), pools)."""
    return lm.serve_step_paged(model, cfg, tokens, pools, block_tables,
                               q_starts, n_reals, n_decode=n_decode,
                               read_pps=read_pps, impl=impl)
