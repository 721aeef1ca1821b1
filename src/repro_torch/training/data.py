"""Deterministic synthetic data pipeline — ``repro/training/data.py``.

Seeded, shardable, restart-reproducible: batch ``i`` is a pure function of
(seed, step, shard), so checkpoint-restart resumes the exact stream with no
stored iterator state. The token stream is a Zipfian-ish mixture with local
n-gram structure so losses decrease during a run. The numpy draws are the
reference's, call for call, so the tokens are bit-identical to it; batches
are CPU tensors (the model moves them to its device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


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


def make_batch(cfg: DataConfig, mcfg: ModelConfig, step: int) -> Dict:
    """{"tokens": (batch / n_shards, seq_len) int32 CPU tensor}. The port's
    models take no prefix embeddings (``n_prefix_embeds == 0``) and no
    encoder input."""
    if mcfg.n_prefix_embeds:
        raise NotImplementedError(f"{mcfg.name}: prefix embeddings are not "
                                  "ported")
    rng = _batch_rng(cfg, step)
    b = cfg.batch // cfg.n_shards
    return {"tokens": torch.from_numpy(
        synthetic_tokens(rng, (b, cfg.seq_len), mcfg.vocab_size))}


def data_stream(cfg: DataConfig, mcfg: ModelConfig,
                start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield make_batch(cfg, mcfg, step)
        step += 1
