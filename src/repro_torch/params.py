"""Carry weights across from the JAX package.

``from_jax`` takes the reference's parameter pytree AS NUMPY ARRAYS (e.g.
``jax.tree.map(np.asarray, api.init_params(key, cfg))``), so the port needs no
``jax`` to read it, and returns the port's :class:`~repro_torch.models.lm.LM`.
The leading layer-group axis of ``blocks`` is unstacked into one module per
layer: ``blocks.sub{i}`` at group g is layer g x group_size + i (gemma3:
six sub-layers a group), with ``{n1, n2, mix.*, ffn.*}`` for the dense,
MoE and hybrid families (the mixer attention, with qk-norm its ``q_norm``
and ``k_norm``, MLA or Mamba, the feed-forward an MLP or the MoE's
router, experts and shared experts) and ``{n1, n2, mix.tm.*, mix.cm.*}``
for RWKV-6. An encoder-decoder tree's ``enc_blocks`` (E) and
``dec_blocks`` (L) are unstacked the same way into
``enc_blocks[e].{n1, attn.*, n2, ffn.*}`` and ``dec_blocks[l].{n1,
self.*, n2, cross.{wq, wk, wv, wo}, n3, ffn.*}``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ENCDEC, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.layers.moe import MoE
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM, group_size, mixer_kind

_TM_LINEARS = ("wr", "wk", "wv", "wg", "wo")
_TM_RAW = ("mu_x", "maa", "mix_w1", "mix_w2", "w0", "decay_w1", "decay_w2",
           "u", "ln_x")
_MAMBA_LINEARS = ("in_proj", "x_proj", "dt_proj", "out_proj")
_MAMBA_RAW = ("conv_w", "conv_b", "dt_bias", "A_log", "D")


def _put(param: torch.nn.Parameter, value, name: str):
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {arr.shape} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(arr, np.float32)))


def _put_linears(module, tree: dict, names, g: int, prefix: str):
    for name in names:
        lin = getattr(module, name)
        _put(lin.w, tree[name]["w"][g], f"{prefix}.{name}.w")
        if lin.b is not None:
            _put(lin.b, tree[name]["b"][g], f"{prefix}.{name}.b")


def _put_mlp(ffn, tree: dict, g: int, prefix: str):
    _put_linears(ffn, tree, [n for n in ("up", "down", "gate")
                             if getattr(ffn, n) is not None], g, prefix)


def _put_embed_and_norm(model, tree: dict):
    _put(model.embed.tok, tree["embed"]["tok"], "embed.tok")
    if model.embed.head is not None:
        _put(model.embed.head, tree["embed"]["head"], "embed.head")
    _put(model.final_norm.scale, tree["final_norm"]["scale"],
         "final_norm.scale")


def _encdec_from_jax(tree: dict, cfg: ModelConfig, device) -> EncDec:
    model = EncDec(cfg, device)
    _put_embed_and_norm(model, tree)
    _put(model.enc_norm.scale, tree["enc_norm"]["scale"], "enc_norm.scale")
    for stack, norms, mixers in (("enc_blocks", ("n1", "n2"), ("attn",)),
                                 ("dec_blocks", ("n1", "n2", "n3"),
                                  ("self", "cross"))):
        sub = tree[stack]
        for l, blk in enumerate(getattr(model, stack)):
            prefix = f"{stack}.{l}"
            for n in norms:
                _put(getattr(blk, n).scale, sub[n]["scale"][l],
                     f"{prefix}.{n}")
            for m in mixers:
                _put_linears(getattr(blk, m), sub[m], ("wq", "wk", "wv", "wo"),
                             l, f"{prefix}.{m}")
            _put_mlp(blk.ffn, sub["ffn"], l, f"{prefix}.ffn")
    return model


def from_jax(tree: dict, cfg: ModelConfig, device=None):
    """Build the port's model (``LM``, or ``EncDec`` for the
    encoder-decoder family) from a reference param tree of numpy arrays,
    on ``device`` (CUDA unless the caller passes another; raises when CUDA
    is absent)."""
    if cfg.family == ENCDEC:
        return _encdec_from_jax(tree, cfg, resolve_device(device))
    model = LM(cfg, resolve_device(device))
    _put_embed_and_norm(model, tree)
    gs = group_size(cfg)
    for l, blk in enumerate(model.blocks):
        g, i = divmod(l, gs)
        sub = tree["blocks"][f"sub{i}"]
        _put(blk.n1.scale, sub["n1"]["scale"][g], f"blocks.{l}.n1")
        _put(blk.n2.scale, sub["n2"]["scale"][g], f"blocks.{l}.n2")
        kind = mixer_kind(cfg, i)
        if kind == "rwkv":
            tm, cm = sub["mix"]["tm"], sub["mix"]["cm"]
            for name in _TM_RAW:
                _put(getattr(blk.mix.tm, name), tm[name][g],
                     f"blocks.{l}.mix.tm.{name}")
            _put_linears(blk.mix.tm, tm, _TM_LINEARS, g, f"blocks.{l}.mix.tm")
            for name in ("mu_k", "mu_r"):
                _put(getattr(blk.mix.cm, name), cm[name][g],
                     f"blocks.{l}.mix.cm.{name}")
            _put_linears(blk.mix.cm, cm, ("wk", "wv", "wr"), g,
                         f"blocks.{l}.mix.cm")
            continue
        if kind == "mamba":
            # A_log and D stay float32: the module holds them so
            for name in _MAMBA_RAW:
                _put(getattr(blk.mix, name), sub["mix"][name][g],
                     f"blocks.{l}.mix.{name}")
            _put_linears(blk.mix, sub["mix"], _MAMBA_LINEARS, g,
                         f"blocks.{l}.mix")
        elif kind == "mla":
            _put_linears(blk.mix, sub["mix"],
                         ("wq", "wdkv", "wuk", "wuv", "wo"), g, f"blocks.{l}")
            _put(blk.mix.kv_norm.scale, sub["mix"]["kv_norm"]["scale"][g],
                 f"blocks.{l}.mix.kv_norm")
        else:
            _put_linears(blk.mix, sub["mix"], ("wq", "wk", "wv", "wo"), g,
                         f"blocks.{l}")
            if blk.mix.q_norm is not None:
                for name in ("q_norm", "k_norm"):
                    _put(getattr(blk.mix, name), sub["mix"][name][g],
                         f"blocks.{l}.mix.{name}")
        ffn, tree_ffn = blk.ffn, sub["ffn"]
        if isinstance(ffn, MoE):
            _put_linears(ffn, tree_ffn, ("router",), g, f"blocks.{l}.ffn")
            for name in ("up", "down", "gate"):
                if getattr(ffn, name) is not None:
                    _put(getattr(ffn, name), tree_ffn[name][g],
                         f"blocks.{l}.ffn.{name}")
            if ffn.shared is None:
                continue
            ffn, tree_ffn = ffn.shared, tree_ffn["shared"]
        _put_mlp(ffn, tree_ffn, g, f"blocks.{l}.ffn")
    return model
