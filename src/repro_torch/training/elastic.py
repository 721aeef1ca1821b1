"""Straggler mitigation — ``repro/training/elastic.py``'s
``RebalancePolicy`` (numpy, host): it consumes per-shard step times and
emits data-parallel bucket sizes, slow shards getting proportionally
smaller micro-batch shares. ``reshard_for_mesh``, which places a restored
tree onto a mesh under the sharding rules, is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


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
