"""Gradient compression: int8 quantization with error feedback —
``repro/training/compression.py`` on one device.

``compress`` / ``decompress`` quantize a tensor against one absmax scale;
the residual is carried in an error-feedback buffer, so the ACCUMULATED
quantization error stays bounded (the EF-SGD guarantee). Plain torch ops
on the gradient's device, float32 throughout: the scale is
``max(max |g + err|, 1e-12) / 127``, the payload ``round((g + err) /
scale)`` (half to even, as ``jnp.round``) clamped to [-127, 127], each op
rounded once as the reference's are (true divisions, no reciprocal), so
a call gives the reference's bits and a CUDA call the CPU's. Trees are nested dicts, lists or tuples of
tensors, such as the train step's ``{name: gradient}``.

``compressed_psum`` is the distributed hook, on ``torch.distributed`` (the
reference's runs inside ``shard_map``): the workers agree on one scale (a
scalar MAX all-reduce), quantize against it, and SUM the payload in int32
(no overflow for <= 2^23 workers) with a float32 count of workers.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch


class CompressedGrad(NamedTuple):
    q: torch.Tensor       # int8 payload
    scale: torch.Tensor   # float32 per-tensor scale (0-d)


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[CompressedGrad, torch.Tensor]:
    """Quantize (g + err) to int8 -> (payload, the new error buffer)."""
    x = g.float() + err
    # a divisor held on the device: CUDA multiplies by the reciprocal of a
    # Python scalar divisor, one rounding off the reference's quotient
    scale = torch.clamp_min(x.abs().max(), 1e-12) / torch.full(
        (), 127.0, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - q.float() * scale
    return CompressedGrad(q, scale), new_err


def decompress(c: CompressedGrad) -> torch.Tensor:
    return c.q.float() * c.scale


def _tree_map(fn, *trees):
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def init_error_buffers(grads) -> Any:
    """A float32 zero buffer shaped like each gradient, on its device."""
    return _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads)


def compress_tree(grads, err_tree):
    """``compress`` leaf by leaf -> (the tree of ``CompressedGrad``, the
    tree of new error buffers), both shaped like ``grads``."""
    errs = []

    def one(g, e):
        c, new_err = compress(g, e)
        errs.append(new_err)
        return c
    comps = _tree_map(one, grads, err_tree)
    it = iter(errs)
    return comps, _tree_map(lambda _: next(it), grads)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce mean with error feedback over ``group`` (the default
    process group when None) -> (the mean of the workers' dequantized
    payloads, this worker's new error buffer).

    Integer payloads from different workers can only be summed under one
    scale, so the workers first agree on the largest local scale, quantize
    against it, then sum the payload in int32. Error feedback absorbs the
    coarser shared-scale quantization on workers with small gradients."""
    import torch.distributed as dist
    x = g.float() + err
    scale = torch.clamp_min(x.abs().max(), 1e-12) / torch.full(
        (), 127.0, device=x.device)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - q.float() * scale
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    n = torch.ones((), dtype=torch.float32, device=x.device)
    dist.all_reduce(n, op=dist.ReduceOp.SUM, group=group)
    return qsum.float() * scale / n, new_err
