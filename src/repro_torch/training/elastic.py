"""Elastic re-scaling and straggler mitigation — ``repro/training/
elastic.py`` in the port.

Checkpoints store logical (unsharded) tensors, so elastic re-scaling is
re-sharding at load: ``reshard_for_mesh`` places a restored tree onto a
mesh (``launch/mesh.py``) under per-leaf specs (``distributed/sharding.
py``). On a one-device mesh every leaf moves to that device. On a mesh of
several entries each leaf becomes the list of its ``Shard`` entries, one
per mesh entry, what the reference's ``addressable_shards`` hold: the
entry's device, its index slices and its piece of the leaf.

``RebalancePolicy`` (numpy, host) consumes per-shard step times and emits
data-parallel bucket sizes, slow shards getting proportionally smaller
micro-batch shares.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import _map_with_path


class Shard(NamedTuple):
    device: torch.device
    index: Tuple[slice, ...]
    data: torch.Tensor


def _shard_index(shape, spec, sizes: dict, coords: dict
                 ) -> Tuple[slice, ...]:
    """The slices of the entry at mesh coordinates ``coords`` under
    ``spec``: a dimension over axes (a, b, ...) is cut into prod(sizes)
    equal pieces, the entry's piece numbered by its coordinates along
    those axes, major first; an uncut dimension is ``slice(None)``."""
    index = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        count = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if count == 1:
            index.append(slice(None))
            continue
        k = 0
        for a in axes:
            k = k * sizes[a] + coords[a]
        step = n // count
        index.append(slice(k * step, (k + 1) * step))
    return tuple(index)


def reshard_for_mesh(tree, mesh, rules_fn):
    """Place a (host-resident) tree — a module's ``{name: tensor}`` dict or
    any nest of dicts, lists and tuples — onto ``mesh`` under the specs
    ``rules_fn(path, leaf)`` gives (``path`` the leaf's dotted name). One
    entry: each leaf on that device. Several: each leaf as the list of its
    ``Shard`` entries, one per mesh entry in the mesh's order."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    devices = list(mesh.devices.flat)
    if len(devices) == 1:
        return _map_with_path(lambda _, leaf: leaf.detach().to(devices[0]),
                              tree)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

    def shards(path, leaf):
        spec = rules_fn(path, leaf)
        out = []
        for pos in np.ndindex(mesh.devices.shape):
            idx = _shard_index(leaf.shape, spec, sizes,
                               dict(zip(mesh.axis_names, pos)))
            dev = mesh.devices[pos]
            out.append(Shard(dev, idx,
                             leaf.detach()[idx].to(dev).contiguous()))
        return out
    return _map_with_path(shards, tree)


@dataclass
class RebalancePolicy:
    """Weighted data-parallel bucket assignment from observed shard step
    times."""
    n_shards: int
    smoothing: float = 0.5
    min_share: float = 0.25
    _ema: Optional[np.ndarray] = None

    def update(self, shard_times: List[float]) -> np.ndarray:
        t = np.asarray(shard_times, np.float64)
        self._ema = t if self._ema is None else \
            self.smoothing * self._ema + (1 - self.smoothing) * t
        speed = 1.0 / np.maximum(self._ema, 1e-9)
        share = speed / speed.sum() * self.n_shards
        share = np.maximum(share, self.min_share)
        return share / share.sum()

    def bucket_sizes(self, global_batch: int, shard_times: List[float]
                     ) -> List[int]:
        share = self.update(shard_times)
        sizes = np.floor(share * global_batch).astype(int)
        sizes = np.maximum(sizes, 1)
        # the remainder goes to the fastest shards
        rem = global_batch - sizes.sum()
        order = np.argsort(-share)
        for i in range(abs(int(rem))):
            sizes[order[i % self.n_shards]] += int(np.sign(rem))
        return sizes.tolist()
