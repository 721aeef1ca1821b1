"""Per-tensor sharding rules with divisibility fallbacks —
``repro/distributed/sharding.py`` in the port.

The rules are name-aware where it matters (attention in/out projections,
MoE expert stacks, embeddings) and fall back to a size-greedy choice
everywhere else. Every rule checks divisibility against the mesh axis size
and degrades to replication rather than failing.

Conventions:
  * batch-bearing inputs shard over ("pod", "data")
  * weight matrices: input-features x output-features -> P(fsdp, "model")
    for in-projections, P("model", fsdp) for out-projections
  * MoE expert stacks (E, d, f): expert axis over "model" when divisible
  * KV caches (G, B, ...): batch over dp; kv-head over "model" when
    divisible, else sequence, else replicate

Parameters are named as the port's modules name them
(``blocks.3.mix.wq.w``). The port unstacks the reference's leading
layer-group axis into one module per layer (``repro_torch/params.py``), so
a ``blocks`` / ``enc_blocks`` / ``dec_blocks`` leaf's spec here is the
reference's with its group entry dropped; a block's norm scale is ``(d,)``
here where the reference's is ``(G, d)``. The dense decode cache keeps the
reference's stacked ``(G, B, ...)`` layout, so its specs are the
reference's as they are.

``PartitionSpec`` is the port's own: a tuple whose entries are ``None``,
an axis name, or a tuple of axis names. ``shard_map_compat`` has no
counterpart: the port's mesh-tier legs are plain copies
(``distributed/mesh_tiers.py``), not programs mapped over a mesh.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor, as jax's ``P``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __reduce__(self):
        # copy and pickle rebuild a spec from its entries, not its tuple
        return (type(self), tuple(self))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# parameter-name classes
_IN_PROJ = ("wq", "wk", "wv", "up", "gate", "mix_w1", "decay_w1", "in_proj",
            "x_proj", "wdkv", "wuk", "wuv", "q_a", "v_a")
_OUT_PROJ = ("wo", "down", "out_proj", "mix_w2", "decay_w2", "dt_proj",
             "q_b", "v_b")


def _path_names(path) -> Tuple[str, ...]:
    """A dotted parameter name (``blocks.0.mix.wq.w``) or a sequence of
    keys -> its components."""
    if isinstance(path, str):
        return tuple(path.split("."))
    return tuple(str(p) for p in path)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _named(tree) -> Dict[str, torch.Tensor]:
    """A module's parameters, or a ``{name: tensor}`` dict as it is."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


class ShardingRules:
    def __init__(self, mesh, cfg: ModelConfig, *, fsdp: bool = True):
        self.mesh = mesh
        self.cfg = cfg
        self.fsdp = fsdp
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        self.model_n = sizes.get("model", 1)
        self.data_n = sizes.get("data", 1)
        self.dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        self.dp_n = int(np.prod([sizes[a] for a in self.dp])) \
            if self.dp else 1

    # ------------------------------------------------------------------
    def param_spec(self, path, leaf) -> PartitionSpec:
        """The spec of one parameter: ``path`` its dotted name (or keys),
        ``leaf`` anything with a ``shape``."""
        names = _path_names(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        dims = list(range(nd))
        spec: list = [None] * nd
        if not dims:
            return P()
        leafname = names[-1] if names[-1] not in ("w", "b") else names[-2]

        # expert stacks (E, d, f): expert axis -> model (EP)
        if leafname in ("up", "down", "gate") and nd == 3:
            e_dim = dims[0]
            if _div(shape[e_dim], self.model_n):
                spec[e_dim] = "model"
                if self.fsdp and _div(shape[e_dim + 1], self.data_n):
                    spec[e_dim + 1] = "data"
                return P(*spec)
        # embeddings: vocab x d_model
        if leafname in ("tok", "head"):
            big = max(dims, key=lambda i: shape[i])
            if _div(shape[big], self.model_n):
                spec[big] = "model"
            other = [i for i in dims if i != big]
            if self.fsdp and other and _div(shape[other[0]], self.data_n):
                spec[other[0]] = "data"
            return P(*spec)
        if nd == 2:
            i, o = dims
            if leafname in _IN_PROJ:
                tp, fs = o, i
            elif leafname in _OUT_PROJ:
                tp, fs = i, o
            else:
                tp, fs = (o, i) if shape[o] >= shape[i] else (i, o)
            if _div(shape[tp], self.model_n):
                spec[tp] = "model"
            if self.fsdp and _div(shape[fs], self.data_n):
                spec[fs] = "data"
            return P(*spec)
        # 1-D (biases, norms) and small leftovers: replicate; fsdp big
        # vectors
        if nd == 1 and self.fsdp and shape[0] >= 1 << 16 \
                and _div(shape[0], self.data_n):
            spec[0] = "data"
        return P(*spec)

    def params(self, params) -> Dict[str, PartitionSpec]:
        """``{name: spec}`` over a module's parameters (or a ``{name:
        tensor}`` dict)."""
        return {n: self.param_spec(n, t) for n, t in _named(params).items()}

    # ------------------------------------------------------------------
    def cache_spec(self, path, leaf, batch: int) -> PartitionSpec:
        """The spec of one stacked cache leaf ``(G, B, ...)``: batch over
        dp; then one axis over "model" — for rank-5 leaves (K/V caches
        (G, B, S, K, hd), RWKV states (G, B, H, hd, hd)) dim 3, else dim 2;
        for latent caches their trailing feature dim first. Never the
        attention head dim."""
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: list = [None] * nd
        bdim = 1 if nd >= 2 and shape[1] == batch else None
        if bdim is not None and _div(batch, self.dp_n):
            spec[bdim] = self.dp
        if nd >= 5:
            order = [3, 2]
        else:
            order = [nd - 1, 2] if nd >= 3 else list(range(2, nd))
        for d in order:
            if 2 <= d < nd and spec[d] is None and _div(shape[d],
                                                         self.model_n):
                spec[d] = "model"
                break
        return P(*spec)

    def cache(self, cache_tree, batch: int):
        """``cache_spec`` over a decode state (``api.init_decode_state``:
        a dict of per-kind NamedTuples, or any nest of dicts, lists and
        tuples), shaped like it."""
        return _map_with_path(
            lambda p, l: self.cache_spec(p, l, batch), cache_tree)

    # ------------------------------------------------------------------
    def batch_spec(self, leaf, batch: int) -> PartitionSpec:
        nd = len(leaf.shape)
        if nd >= 1 and leaf.shape[0] == batch and _div(batch, self.dp_n):
            return P(self.dp, *([None] * (nd - 1)))
        return P(*([None] * nd))

    def batch(self, tree, batch: int):
        return _map_with_path(lambda _, l: self.batch_spec(l, batch), tree)

    # ------------------------------------------------------------------
    def opt_state(self, opt_template, params):
        """The optimizer state's specs: moments and master mirror the
        parameter specs; the step is replicated."""
        from repro_torch.training.optimizer import AdamWState
        pspecs = self.params(params)

        def build(field):
            if field is None:
                return None
            return {n: pspecs[n] for n in field}
        return AdamWState(P(), build(opt_template.mu),
                          build(opt_template.nu), build(opt_template.master))


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nest of dicts, lists, tuples and
    NamedTuples, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(".".join(path), tree)
