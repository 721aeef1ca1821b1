"""Carry weights across from the JAX package.

``from_jax`` takes the reference's parameter pytree AS NUMPY ARRAYS (e.g.
``jax.tree.map(np.asarray, api.init_params(key, cfg))``), so the port needs no
``jax`` to read it, and returns the port's :class:`~repro_torch.models.lm.LM`.
The leading layer-group axis of ``blocks`` is unstacked into one module per
layer: ``blocks.sub0.{n1, n2, mix.*, ffn.*}`` for the dense family,
``blocks.sub0.{n1, n2, mix.tm.*, mix.cm.*}`` for RWKV-6.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.lm import LM, mixer_kind

_TM_LINEARS = ("wr", "wk", "wv", "wg", "wo")
_TM_RAW = ("mu_x", "maa", "mix_w1", "mix_w2", "w0", "decay_w1", "decay_w2",
           "u", "ln_x")


def _put(param: torch.nn.Parameter, value, name: str):
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {arr.shape} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(arr, np.float32)))


def _put_linears(module, tree: dict, names, l: int, prefix: str):
    for name in names:
        lin = getattr(module, name)
        _put(lin.w, tree[name]["w"][l], f"{prefix}.{name}.w")
        if lin.b is not None:
            _put(lin.b, tree[name]["b"][l], f"{prefix}.{name}.b")


def from_jax(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """Build the port's model from a reference param tree of numpy arrays,
    on ``device`` (CUDA unless the caller passes another; raises when CUDA
    is absent)."""
    model = LM(cfg, resolve_device(device))
    _put(model.embed.tok, tree["embed"]["tok"], "embed.tok")
    if model.embed.head is not None:
        _put(model.embed.head, tree["embed"]["head"], "embed.head")
    _put(model.final_norm.scale, tree["final_norm"]["scale"],
         "final_norm.scale")
    sub = tree["blocks"]["sub0"]
    for l, blk in enumerate(model.blocks):
        _put(blk.n1.scale, sub["n1"]["scale"][l], f"blocks.{l}.n1")
        _put(blk.n2.scale, sub["n2"]["scale"][l], f"blocks.{l}.n2")
        if mixer_kind(cfg) == "rwkv":
            tm, cm = sub["mix"]["tm"], sub["mix"]["cm"]
            for name in _TM_RAW:
                _put(getattr(blk.mix.tm, name), tm[name][l],
                     f"blocks.{l}.mix.tm.{name}")
            _put_linears(blk.mix.tm, tm, _TM_LINEARS, l, f"blocks.{l}.mix.tm")
            for name in ("mu_k", "mu_r"):
                _put(getattr(blk.mix.cm, name), cm[name][l],
                     f"blocks.{l}.mix.cm.{name}")
            _put_linears(blk.mix.cm, cm, ("wk", "wv", "wr"), l,
                         f"blocks.{l}.mix.cm")
            continue
        _put_linears(blk.mix, sub["mix"], ("wq", "wk", "wv", "wo"), l,
                     f"blocks.{l}")
        _put_linears(blk.ffn, sub["ffn"],
                     [n for n in ("up", "down", "gate")
                      if getattr(blk.ffn, n) is not None], l,
                     f"blocks.{l}.ffn")
    return model
