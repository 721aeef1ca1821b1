"""Carry weights across from the JAX package.

``from_jax`` takes the reference's parameter pytree AS NUMPY ARRAYS (e.g.
``jax.tree.map(np.asarray, api.init_params(key, cfg))``), so the port needs no
``jax`` to read it, and returns the port's :class:`~repro_torch.models.lm.
DenseLM`. The leading layer-group axis of ``blocks`` is unstacked into one
module per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.lm import DenseLM


def _put(param: torch.nn.Parameter, value, name: str):
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {arr.shape} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(arr, np.float32)))


def from_jax(tree: dict, cfg: ModelConfig, device=None) -> DenseLM:
    """Build the port's model from a reference param tree of numpy arrays,
    on ``device`` (CUDA unless the caller passes another; raises when CUDA
    is absent)."""
    model = DenseLM(cfg, resolve_device(device))
    _put(model.embed.tok, tree["embed"]["tok"], "embed.tok")
    _put(model.final_norm.scale, tree["final_norm"]["scale"],
         "final_norm.scale")
    sub = tree["blocks"]["sub0"]
    for l, blk in enumerate(model.blocks):
        _put(blk.n1.scale, sub["n1"]["scale"][l], f"blocks.{l}.n1")
        _put(blk.n2.scale, sub["n2"]["scale"][l], f"blocks.{l}.n2")
        for name in ("wq", "wk", "wv", "wo"):
            lin = getattr(blk.mix, name)
            _put(lin.w, sub["mix"][name]["w"][l], f"blocks.{l}.{name}.w")
            if lin.b is not None:
                _put(lin.b, sub["mix"][name]["b"][l], f"blocks.{l}.{name}.b")
        for name in ("up", "down", "gate"):
            lin = getattr(blk.ffn, name)
            if lin is not None:
                _put(lin.w, sub["ffn"][name]["w"][l],
                     f"blocks.{l}.ffn.{name}.w")
    return model
