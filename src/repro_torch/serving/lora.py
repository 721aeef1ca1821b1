"""LoRA adapters and the AQUA adapter cache (paper §6.1, Figs. 8 and 12) —
``repro/serving/lora.py`` on the port's :class:`AquaTensor`.

An adapter is one (A, B) pair per layer for the query and value
projections. The cache packs a whole adapter into ONE contiguous blob of
pages in the adapter's native dtype, so fetching a cold adapter from the
donor GPU is one fabric message (the paper's fix for the many-small-copies
problem), not one per layer.

``apply_lora`` merges an adapter into a model, ``W' = W + (alpha/r) A @ B``
(the classic LoRA placement, single-adapter serving). The serving engine
keeps ``lora_id`` only as the prefix index's partition key, as the
reference does; it applies no adapter per request.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.aqua_tensor import REMOTE, AquaTensor, TransferMeter
from repro_torch.core.device import resolve_device
from repro_torch.layers.core import trunc_normal
from repro_torch.models.lm import LM, group_size

_LEAVES = ("q_a", "q_b", "v_a", "v_b")       # the reference's leaf order


def init_adapter(generator: torch.Generator, cfg: ModelConfig,
                 rank: int = 16, alpha: float = 32.0) -> dict:
    """One (A, B) pair per layer for wq and wv, on the generator's device:
    ``q_a``/``v_a`` (L, d, r) truncated normal of std 1/sqrt(d), ``q_b``
    (L, r, H hd) and ``v_b`` (L, r, K hd) zeros, in the config's param
    dtype (the reference's ``init_adapter``)."""
    hd, d, L, dt = (cfg.resolved_head_dim, cfg.d_model, cfg.n_layers,
                    cfg.dtype())
    dev = generator.device
    std = 1.0 / math.sqrt(d)
    return {
        "alpha": alpha, "rank": rank,
        "q_a": trunc_normal((L, d, rank), std, dt, generator, dev),
        "q_b": torch.zeros((L, rank, cfg.n_heads * hd), dtype=dt, device=dev),
        "v_a": trunc_normal((L, d, rank), std, dt, generator, dev),
        "v_b": torch.zeros((L, rank, cfg.n_kv_heads * hd), dtype=dt,
                           device=dev),
    }


def adapter_from_numpy(adapter: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's adapter with its arrays as numpy (e.g.
    ``jax.tree.map(np.asarray, ad)``) as the port's: the same values in the
    config's param dtype on ``device`` (CUDA unless the caller passes
    another; raises when CUDA is absent)."""
    device = resolve_device(device)
    out = {"alpha": adapter["alpha"], "rank": adapter["rank"]}
    for k in _LEAVES:
        out[k] = torch.from_numpy(np.array(adapter[k], np.float32)).to(
            device, cfg.dtype())
    return out


def adapter_arrays(adapter: dict) -> Dict[str, torch.Tensor]:
    """The adapter's tensors (not ``alpha`` / ``rank``)."""
    return {k: v for k, v in adapter.items() if isinstance(v, torch.Tensor)}


def adapter_bytes(adapter: dict) -> int:
    return sum(v.numel() * v.element_size()
               for v in adapter_arrays(adapter).values())


def _share(module: nn.Module) -> nn.Module:
    """A copy of the module tree whose every module is new and whose every
    parameter is the original's tensor (nothing is copied)."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = {k: None if m is None else _share(m)
                    for k, m in module._modules.items()}
    return new


def apply_lora(model: LM, cfg: ModelConfig, adapter: dict) -> LM:
    """The model with the adapter merged into every layer's query and value
    projections, ``w + ((alpha / r) A @ B)`` cast to ``w``'s dtype (the
    reference's ``apply_lora``; ``w`` is (d_in, d_out) in both packages).
    The result shares every other tensor with ``model``, which is left
    unchanged: only the 2 L merged weights are new memory.

    Raises:
        ValueError: the stack is not homogeneous (group size != 1).
    """
    gs = group_size(cfg)
    if gs != 1:
        raise ValueError(
            f"{cfg.name}: adapter merge supported for homogeneous stacks "
            f"only (group size {gs})")
    scale = adapter["alpha"] / adapter["rank"]
    merged = _share(model)
    for l, blk in enumerate(merged.blocks):
        for name, a, b in (("wq", "q_a", "q_b"), ("wv", "v_a", "v_b")):
            lin = getattr(blk.mix, name)
            w = lin.w
            delta = torch.matmul(adapter[a][l].to(w.device),
                                 adapter[b][l].to(w.device)) * scale
            lin._parameters["w"] = nn.Parameter(w + delta.to(w.dtype),
                                                requires_grad=False)
    return merged


class AdapterCache:
    """LRU adapter cache over an AquaTensor: hot adapters LOCAL, cold ones on
    the donor GPU (fabric) or host. A fetch is one coalesced blob transfer.

    Adapters page in their NATIVE dtype: every tensor leaf is raveled into
    one contiguous vector of ``dtype`` (pass the model's param dtype), cut
    into pages of ``page_elems``; the tail page is zero-padded. The pages
    live on ``device`` (CUDA unless the caller passes another; raises when
    CUDA is absent) and its host tier.
    """

    def __init__(self, *, capacity_local: int, page_elems: int = 65536,
                 dtype: torch.dtype = torch.float32,
                 meter: Optional[TransferMeter] = None, device=None):
        self.capacity = capacity_local
        self.page_elems = page_elems
        self.aqua = AquaTensor(
            n_logical=4096, page_shape=(page_elems,),
            local_slots=max(capacity_local * 2, 4), host_slots=4096,
            dtype=dtype, meter=meter, name="lora", device=device)
        self._parked: Dict[int, tuple] = {}
        self._lru: list = []

    def blob(self, adapter: dict) -> torch.Tensor:
        """The adapter's leaves (``q_a``, ``q_b``, ``v_a``, ``v_b``)
        raveled into one vector of the cache's dtype, zero-padded to whole
        pages: (n_pages, page_elems) on the cache's device."""
        arrays = adapter_arrays(adapter)
        flat = torch.cat([arrays[k].reshape(-1).to(self.aqua.device,
                                                   self.aqua.dtype)
                          for k in sorted(arrays)])
        n_pages = -(-flat.numel() // self.page_elems)
        flat = torch.nn.functional.pad(
            flat, (0, n_pages * self.page_elems - flat.numel()))
        return flat.reshape(n_pages, self.page_elems)

    def put(self, aid: int, adapter: dict):
        """Park adapter ``aid``: its blob on freshly allocated pages,
        preferring the donor (REMOTE, then HOST), one metered write per
        tier and donor."""
        pages = self.blob(adapter)
        lps = self.aqua.allocate(pages.shape[0], prefer=REMOTE)
        self.aqua.write(lps, pages)
        # the adapter object is retained beside the paged blob: fetch()
        # meters the coalesced page-in and returns the retained object
        self._parked[aid] = (lps, adapter)

    def pages_of(self, aid: int) -> np.ndarray:
        return self._parked[aid][0]

    def fetch(self, aid: int) -> dict:
        """Bring an adapter into the local tier: a miss reads its pages
        with the meter on (one message per tier they lie on), a hit is
        free; evictions from the LRU of ``capacity_local`` are free (the
        pages are a read-only copy)."""
        lps, adapter = self._parked[aid]
        if aid not in self._lru:
            self.aqua.read(lps, meter=True)
            self._lru.append(aid)
            if len(self._lru) > self.capacity:
                self._lru.pop(0)
        else:
            self._lru.remove(aid)
            self._lru.append(aid)
        return adapter

    @property
    def hits_resident(self):
        return list(self._lru)
