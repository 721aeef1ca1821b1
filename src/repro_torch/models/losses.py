"""Next-token cross-entropy — ``repro/models/losses.py``, on one device and
on a rank of the partitioned train step.

The reference constrains the logits to ``P(dp, None, "model")`` and lets
the partitioner reduce ``logsumexp(logits)`` and the target logit over the
sharded vocabulary with a psum, so that no device holds the (B, T, V)
float32 logits. On a rank the same reductions are written out with
``RankContext``'s collectives (``distributed/partition.py``).
"""
from __future__ import annotations

import torch


def shifted_xent(logits, tokens, shard_axes=None):
    """Next-token CE. logits: (B, T, V) aligned with tokens (B, T) -> the
    mean over B (T - 1) of ``logsumexp(logits) - logits[target]``, in
    float32. The target logit is gathered: the reference contracts with a
    float32 one-hot so that a vocab-sharded reduction needs no all-gather,
    which on one device would only cost a (B, T, V) float32 tensor (5 GB
    at qwen1.5-0.5b's vocab, batch 4, 2048 tokens).

    With ``shard_axes`` (``ctx``, the rank's ``RankContext``, and
    ``vocab``, the mesh axis the logits' vocabulary is split over, or
    None), the rank's logits:

    * a vocabulary slice (B, T, V / n): each row's log-sum-exp is its
      slice's, combined over the axis as ``M + log(sum_r exp(lse_r -
      M))`` with M the rows' maximum (an all-reduce of the maxima, then of
      the sums), and the target logit is the slice's that holds it, summed
      over the axis. At a group of one both are exactly the unsharded
      values.
    * with ``seq`` (the axis the positions are split over; the vocabulary
      whole): the rank's block of the positions of the whole stream
      (B, T_l, V), the first ``prefix`` of which take no loss (a VLM's
      prefix rows; ``tokens`` are the text's). Each rank sums the loss of
      its positions; the sum is all-reduced over ``seq``."""
    if shard_axes and shard_axes.get("seq"):
        return _seq_xent(logits, tokens, shard_axes)
    lf = logits[:, :-1].float()
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(lf, dim=-1)
    axis = shard_axes.get("vocab") if shard_axes else None
    if axis is None:
        tl = torch.gather(lf, -1, tgt[..., None])[..., 0]
        return (lse - tl).mean()
    rank = shard_axes["ctx"]
    V = lf.shape[-1]
    lo, _ = rank.range(axis, V)
    m = rank.all_reduce(lse.detach(), axis, "max")
    lse = m + torch.log(rank.all_reduce(torch.exp(lse - m), axis))
    local = tgt - lo
    own = (local >= 0) & (local < V)
    tl = torch.gather(lf, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    tl = rank.all_reduce(torch.where(own, tl, torch.zeros_like(tl)), axis)
    return (lse - tl).mean()


def _seq_xent(logits, tokens, shard_axes):
    rank, axis = shard_axes["ctx"], shard_axes["seq"]
    B, Tl, _ = logits.shape
    T = tokens.shape[1]
    lo, _ = rank.range(axis, Tl)
    j = torch.arange(Tl, device=logits.device) + lo - shard_axes["prefix"]
    valid = (j >= 0) & (j < T - 1)
    tgt = tokens[:, (j + 1).clamp(0, T - 1)].long()
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - torch.gather(
        lf, -1, tgt[..., None])[..., 0]
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    return rank.all_reduce(total, axis) / (B * (T - 1))
