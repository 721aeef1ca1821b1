"""Deterministic synthetic data pipeline — ``repro/training/data.py``.

Seeded, shardable, restart-reproducible: batch ``i`` is a pure function of
(seed, step, shard), so checkpoint-restart resumes the exact stream with no
stored iterator state. The token stream is a Zipfian-ish mixture with local
n-gram structure so losses decrease during a run. The numpy draws are the
reference's, call for call, so the tokens (and a VLM's prefix
embeddings, an encoder-decoder's encoder embeddings) are bit-identical to
it; batches are CPU tensors (the model
moves them to its device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ENCDEC, ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    n_shards: int = 1
    shard: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard]))


def synthetic_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-weighted markov-ish stream: next token correlates with previous."""
    v_eff = min(vocab, 4096)
    base = rng.zipf(1.3, size=shape) % v_eff
    prev = np.roll(base, 1, axis=-1)
    mix = rng.random(shape) < 0.35
    out = np.where(mix, (prev * 31 + 7) % v_eff, base)
    return out.astype(np.int32)


def _as_compute(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """float64 draws in the compute dtype, rounded as ``jnp.asarray(x,
    dtype)`` rounds them: to float32 first, then to the compute dtype."""
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def make_batch(cfg: DataConfig, mcfg: ModelConfig, step: int) -> Dict:
    """{"tokens": (batch / n_shards, seq_len - n_prefix_embeds) int32 CPU
    tensor}, and for a VLM {"prefix_embeds": (batch / n_shards,
    n_prefix_embeds, d_model)}, and for an encoder-decoder {"enc_embeds":
    (batch / n_shards, encoder_seq_len, d_model)}, each 0.02 x standard
    normal drawn after the tokens (and the prefix embeddings), in the
    reference's order, in the compute dtype."""
    rng = _batch_rng(cfg, step)
    b = cfg.batch // cfg.n_shards
    t_text = cfg.seq_len - mcfg.n_prefix_embeds
    if t_text < 1:
        raise ValueError(f"{mcfg.name}: seq_len {cfg.seq_len} leaves no text "
                         f"after {mcfg.n_prefix_embeds} prefix positions")
    batch = {"tokens": torch.from_numpy(
        synthetic_tokens(rng, (b, t_text), mcfg.vocab_size))}
    if mcfg.n_prefix_embeds:
        batch["prefix_embeds"] = _as_compute(
            rng.standard_normal((b, mcfg.n_prefix_embeds, mcfg.d_model))
            * 0.02, mcfg.torch_compute_dtype())
    if mcfg.family == ENCDEC:
        batch["enc_embeds"] = _as_compute(
            rng.standard_normal((b, mcfg.encdec.encoder_seq_len,
                                 mcfg.d_model)) * 0.02,
            mcfg.torch_compute_dtype())
    return batch


def data_stream(cfg: DataConfig, mcfg: ModelConfig,
                start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield make_batch(cfg, mcfg, step)
        step += 1
