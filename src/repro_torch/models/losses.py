"""Next-token cross-entropy — ``repro/models/losses.py`` on one device (the
reference's sharding constraints have nothing to constrain here)."""
from __future__ import annotations

import torch


def shifted_xent(logits, tokens):
    """Next-token CE. logits: (B, T, V) aligned with tokens (B, T) -> the
    mean over B (T - 1) of ``logsumexp(logits) - logits[target]``, in
    float32. The target logit is gathered: the reference contracts with a
    float32 one-hot so that a vocab-sharded reduction needs no all-gather,
    which on one device would only cost a (B, T, V) float32 tensor (5 GB
    at qwen1.5-0.5b's vocab, batch 4, 2048 tokens)."""
    lf = logits[:, :-1].float()
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(lf, dim=-1)
    tl = torch.gather(lf, -1, tgt[..., None])[..., 0]
    return (lse - tl).mean()
