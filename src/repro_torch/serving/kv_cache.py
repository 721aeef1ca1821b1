"""Paged state runtime: a request's dynamic context on AquaTensor pages,
behind per-request block tables — ``repro/serving/kv_cache.py`` for the
token and state planes of the families the port serves.

``PagedStateRuntime`` is the serving engine's state manager. Each plane of
``lm.paged_layout`` is one tiered AquaTensor pool: a TOKEN plane (dense
``kv``, payload ``(2, n_kv, page, hd)``; MLA ``mla``, ``(page, kv_lora +
rope_dim)``) holds ``ceil(ctx/page)`` pages per layer; a STATE plane
(RWKV-6 ``wkv`` ``(H, hd, hd)`` float32 and ``shift`` ``(2, d_model)``;
Mamba ``ssm`` ``(di, ds)`` float32 and ``conv`` ``(d_conv-1, di)``)
holds ONE page per layer, zeroed when allocated (a reused slot holds its
last occupant's state, and the zero page is the initial recurrent state).
A plane spans G layer groups of ``n_sub`` sub-layers
each (jamba: 2 x 7 ``ssm``/``conv`` pages and 2 x 1 ``kv`` rows at 16
layers). The fused step reads and writes the LOCAL pools
directly, so preemption is a page-table tier flip of all planes together:

    park    = offload(pages)      one coalesced message per (tier, donor)
    restore = ensure_local(pages)

PREFIX SHARING (copy-on-write): a radix tree over page-aligned prompt token
blocks lets ``adopt_prefix`` map a new request's block tables onto pages
another request already wrote for the longest common prefix. Shared pages
are refcounted, pinned LOCAL while any referencer is active, moved once
however many tables point at them, and cloned on write (``make_writable``).

GLOBAL PREFIX CACHE: with ``prefix_cache`` on, tree-indexed pages outlive
their last referencer in the CACHED state and yield on demand: each plane's
AquaTensor ``reclaim`` hook evicts the coldest cached blocks (LRU), demoting
LOCAL -> REMOTE -> HOST before freeing, before any allocation can fail.

LEASES AND FAULTS: a donor's byte grant is split across the planes
(``add_remote_lease``); a coordinator reclaim evacuates it to HOST
(``evict_remote``), a lease shrink live-migrates the reclaimed slots' pages
(``shrink_lease``), and a donor loss flips its pages to LOST and names the
victim requests (``fail_donor``), pruning the radix coverage they backed.

SNAPSHOTS: ``snapshot_state`` serializes the block tables, every page's
payload (as host numpy), the radix tree and the counters; ``restore_state``
rebuilds them on a fresh runtime, every page landing on HOST first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.aqua_tensor import (HOST, LOCAL, REMOTE, AquaTensor,
                                          TransferMeter)
from repro_torch.core.device import resolve_device
from repro_torch.core.errors import LeaseRevokedError
from repro_torch.models import lm


@dataclass
class _Plane:
    """One page plane: an AquaTensor pool + the per-request page
    bookkeeping."""
    name: str
    kind: str                        # "tokens" | "state"
    aqua: AquaTensor
    n_layers: int                    # plane layers across the whole stack
    n_sub: int                       # plane sub-layers per group
    token_bytes: int = 0             # per-layer bytes/token
    scratch_lp: int = 0
    pages: Dict[int, List[List[int]]] = field(default_factory=dict)
    # LOCAL pin count per logical page: how many ACTIVE requests reference
    # it. park() offloads only pages whose pin reaches zero.
    pin: Dict[int, int] = field(default_factory=dict)

    @property
    def scratch_slot(self) -> int:
        return int(self.aqua.page_table[self.scratch_lp, 1])

    def flat(self, rid: int) -> np.ndarray:
        return np.asarray([lp for row in self.pages.get(rid, [])
                           for lp in row], np.int64)


def _token_blocks(tokens: Sequence[int], page_tokens: int
                  ) -> List[Tuple[int, ...]]:
    """A prompt's FULL page-aligned token blocks (the partial tail block is
    never indexed)."""
    return [tuple(int(t) for t in tokens[i * page_tokens:(i + 1) * page_tokens])
            for i in range(len(tokens) // page_tokens)]


class _RadixNode:
    """One edge of the prefix radix tree: a run of page-aligned token blocks
    plus the pages backing each block (plane name -> (n_layers,) logical
    ids). Children are keyed by their own first block verbatim, so a hash
    collision reads as a miss. ``last_use`` is the LRU clock tick."""
    __slots__ = ("blocks", "pages", "children", "parent", "last_use")

    def __init__(self, blocks=None, pages=None, parent=None):
        self.blocks: List[Tuple[int, ...]] = blocks if blocks is not None else []
        self.pages: List[Dict[str, np.ndarray]] = pages if pages is not None else []
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.parent: Optional["_RadixNode"] = parent
        self.last_use: int = 0


class PagedStateRuntime:
    """Block-table state manager on tiered AquaTensor pools."""

    def __init__(self, cfg: ModelConfig, *, max_seq: int,
                 page_tokens: int = 8, local_pages: Optional[int] = None,
                 host_pages: int = 8192, n_logical: int = 16384,
                 max_running: int = 4, meter: Optional[TransferMeter] = None,
                 prefix_sharing: bool = True, prefix_cache: bool = True,
                 device=None, mesh=None):
        """Build one AquaTensor pool per page plane of ``cfg``.

        Args:
            cfg: model config; must be paged-servable by the port.
            max_seq: maximum context length a request may reach.
            page_tokens: tokens per page.
            local_pages: LOCAL slots per token plane (the admission
                budget); default sizes for ``max_running`` full-length
                requests. State planes always hold ``max_running`` requests'
                pages.
            host_pages: host-tier slots per plane.
            n_logical: logical page ids per plane (must cover resident AND
                parked pages).
            max_running: used only to size default pools.
            meter: shared ``TransferMeter``; a fresh one by default.
            prefix_sharing: enable the copy-on-write prefix index.
            prefix_cache: retain tree-indexed pages past refcount 0.
            device: serving device of the LOCAL/REMOTE pools (CUDA unless
                the caller passes another).
            mesh: an optional ``MeshTierDomain`` serving from ``device``:
                every plane's REMOTE pools become slabs on donor devices
                and its remote legs one copy each; ``None`` keeps the
                slabs on the serving device.
        """
        layout = lm.paged_layout(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.G = lm.n_groups(cfg)
        self.page_tokens = page_tokens
        self.max_seq = max_seq
        self.pps = math.ceil(max_seq / page_tokens)
        self.meter = meter or TransferMeter()
        self.faults = None
        self.mesh = mesh
        self.planes: Dict[str, _Plane] = {}
        self.sharing = bool(prefix_sharing) and all(
            spec.get("shareable", False) for spec in layout.values())
        self.caching = self.sharing and bool(prefix_cache)
        self._roots: Dict[object, _RadixNode] = {}
        self._lp_node: Dict[Tuple[str, int], Tuple[_RadixNode, int]] = {}
        self._req_blocks: Dict[int, List[Tuple[int, ...]]] = {}
        self._req_seed: Dict[int, object] = {}
        self._req_registered: Dict[int, int] = {}
        self._active: set = set()
        self.prefix_hits = 0
        self.adopted_tokens = 0
        self.cow_copies = 0
        self.cache_hits = 0
        self.cache_hit_tokens = 0
        self.cache_evictions = 0
        self.cache_demotions = 0
        self._clock = 0
        self._evicting = False
        for name, spec in layout.items():
            n_sub = len(spec["positions"])
            n_layers = self.G * n_sub
            if spec["kind"] == "tokens":
                if len(spec["dims"]) == 2:              # kv: K and V heads
                    K, hd = spec["dims"]
                    page_shape = (2, K, page_tokens, hd)
                else:                                   # mla latent plane
                    (C,) = spec["dims"]
                    page_shape = (page_tokens, C)
                # +1 is the scratch page
                slots = (local_pages if local_pages is not None
                         else max_running * n_layers * self.pps + 1)
            else:
                page_shape = tuple(spec["shape"])
                slots = max_running * n_layers + 1
            aqua = AquaTensor(n_logical=n_logical, page_shape=page_shape,
                              local_slots=slots, host_slots=host_pages,
                              dtype=spec["dtype"], meter=self.meter,
                              name=f"{cfg.name}/{name}", device=self.device,
                              mesh=mesh)
            plane = _Plane(name, spec["kind"], aqua, n_layers, n_sub,
                           token_bytes=spec.get("token_bytes", 0))
            # pinned LOCAL dummy page: idle lanes and block-table padding
            # point here so masked reads stay in bounds
            plane.scratch_lp = int(aqua.allocate(1, prefer=LOCAL)[0])
            self.planes[name] = plane
            if self.caching:
                aqua.reclaim = (lambda tier, need, _n=name:
                                self._cache_reclaim(_n, tier, need))

    # -- geometry ---------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        """Token-plane pages per layer covering n_tokens."""
        return max(1, math.ceil(n_tokens / self.page_tokens))

    def _plane_pages(self, plane: _Plane, n_tokens: int) -> int:
        if plane.kind == "tokens":
            return plane.n_layers * self.pages_for(n_tokens)
        return plane.n_layers

    def footprint_bytes(self, n_tokens: int) -> float:
        """Native-dtype whole-context bytes of a request (no page slack):
        token planes at n_tokens, state planes at their fixed size — what
        one park or restore moves."""
        total = 0.0
        for p in self.planes.values():
            if p.kind == "tokens":
                total += p.n_layers * n_tokens * p.token_bytes
            else:
                total += p.n_layers * p.aqua.page_bytes
        return float(total)

    def pages_per_request(self, n_tokens: int) -> np.ndarray:
        """Per-plane page cost of a request at n_tokens of context."""
        return np.asarray([self._plane_pages(p, n_tokens)
                           for p in self.planes.values()], np.int64)

    @property
    def page_budget(self) -> np.ndarray:
        """Per-plane LOCAL pages available to requests (scratch excluded)."""
        return np.asarray([p.aqua.local_pool.shape[0] - 1
                           for p in self.planes.values()], np.int64)

    @property
    def pools(self) -> Dict[str, torch.Tensor]:
        return {n: p.aqua.local_pool for n, p in self.planes.items()}

    @pools.setter
    def pools(self, value: Dict[str, torch.Tensor]):
        for n, pool in value.items():
            self.planes[n].aqua.local_pool = pool

    # -- activation bookkeeping (LOCAL pins) -------------------------------
    def _unpin(self, plane: _Plane, lp: int):
        c = plane.pin.get(lp, 0) - 1
        if c <= 0:
            plane.pin.pop(lp, None)
        else:
            plane.pin[lp] = c

    def _activate(self, rid: int):
        """Pull every page the request references LOCAL and pin it there;
        all planes' page-ins ride one coalesced message per (tier, donor)."""
        if rid in self._active:
            return
        self._active.add(rid)
        with self.meter.coalesce():
            for plane in self.planes.values():
                lps = plane.flat(rid)
                if len(lps):
                    plane.aqua.ensure_local(lps)
                    plane.aqua.set_page_fill(lps, 1.0)
                    for lp in lps:
                        lp = int(lp)
                        plane.pin[lp] = plane.pin.get(lp, 0) + 1

    # -- allocation -------------------------------------------------------
    def ensure_capacity(self, rid: int, n_tokens: int):
        """Grow the request's block tables to cover ``n_tokens``, all or
        nothing across planes; implicitly activates the request. Token
        planes add pages as the context crosses page boundaries; state
        planes take their one page per layer on first touch, zeroed. New
        pages must be LOCAL.

        Raises:
            MemoryError: a fresh page cannot be placed (or kept) LOCAL.
        """
        self._activate(rid)
        added: List[Tuple[_Plane, List[int], int]] = []
        fresh_rids: List[_Plane] = []
        try:
            for plane in self.planes.values():
                if rid not in plane.pages:
                    fresh_rids.append(plane)
                rows = plane.pages.setdefault(
                    rid, [[] for _ in range(plane.n_layers)])
                need = (self.pages_for(n_tokens) if plane.kind == "tokens"
                        else 1)
                fresh: List[int] = []
                for row in rows:
                    while len(row) < need:
                        lp = int(plane.aqua.allocate(1, prefer=LOCAL)[0])
                        try:
                            if plane.aqua.page_table[lp, 0] != LOCAL:
                                plane.aqua.ensure_local([lp])  # LOCAL full
                        except MemoryError:
                            plane.aqua.free([lp])
                            raise
                        row.append(lp)
                        added.append((plane, row, lp))
                        plane.pin[lp] = plane.pin.get(lp, 0) + 1
                        if plane.kind == "state":
                            fresh.append(lp)
                if fresh:
                    plane.aqua.write_local(
                        fresh, torch.zeros((len(fresh),)
                                           + plane.aqua.page_shape,
                                           dtype=plane.aqua.dtype,
                                           device=self.device))
        except MemoryError:
            for plane, row, lp in reversed(added):
                self._unpin(plane, lp)
                plane.aqua.free([lp])
                row.remove(lp)
            for plane in fresh_rids:
                if not any(plane.pages.get(rid, [])):
                    plane.pages.pop(rid, None)
            raise

    def release(self, rid: int):
        """Drop the request's references. Shared pages survive; indexed
        pages whose last reference this drops become CACHED (caching on)
        or are freed with their tree coverage pruned (caching off)."""
        for plane in self.planes.values():
            if rid not in plane.pages:
                continue
            lps = plane.flat(rid)
            if rid in self._active:
                for lp in lps:
                    self._unpin(plane, int(lp))
            indexed = [int(lp) for lp in lps
                       if (plane.name, int(lp)) in self._lp_node]
            plain = [int(lp) for lp in lps
                     if (plane.name, int(lp)) not in self._lp_node]
            plane.aqua.free(plain)
            if self.caching:
                plane.aqua.free_to_cache(indexed)
                # a LOST page cannot be cached (free_to_cache freed it):
                # prune its coverage so no arrival adopts it
                for lp in indexed:
                    if plane.aqua.page_table[lp, 0] == -1:
                        self._drop_tree_page(plane.name, lp)
            else:
                for lp in plane.aqua.free(indexed):
                    self._drop_tree_page(plane.name, lp)
            # no pin may survive the pages it pinned (a same-step prefetch
            # restore of a finishing request)
            for lp in lps:
                if plane.aqua.page_table[int(lp), 0] == -1:
                    plane.pin.pop(int(lp), None)
            del plane.pages[rid]
        self._active.discard(rid)
        self._req_blocks.pop(rid, None)
        self._req_seed.pop(rid, None)
        self._req_registered.pop(rid, None)

    # -- radix-tree plumbing ----------------------------------------------
    def _radix_walk(self, seed, blocks):
        """Longest common prefix: one (node, block index) per matched
        block."""
        out: List[Tuple[_RadixNode, int]] = []
        node = self._roots.get(seed)
        if node is None:
            return out
        i = 0
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                break
            j = 0
            while (j < len(child.blocks) and i < len(blocks)
                   and child.blocks[j] == blocks[i]):
                out.append((child, j))
                i += 1
                j += 1
            if j < len(child.blocks):
                break                      # diverged mid-edge
            node = child
        return out

    def _index_pages(self, node: _RadixNode):
        for bi, pagedict in enumerate(node.pages):
            for name, lps in pagedict.items():
                for lp in lps:
                    self._lp_node[(name, int(lp))] = (node, bi)

    def _split_node(self, node: _RadixNode, at: int):
        """Split an edge at block boundary ``at``."""
        tail = _RadixNode(blocks=node.blocks[at:], pages=node.pages[at:],
                          parent=node)
        tail.children = node.children
        tail.last_use = node.last_use
        for c in tail.children.values():
            c.parent = tail
        self._index_pages(tail)
        node.blocks = node.blocks[:at]
        node.pages = node.pages[:at]
        node.children = {tail.blocks[0]: tail}

    def _radix_insert(self, seed, blocks, page_dicts):
        """Publish ``blocks`` with their pages into the seed's tree."""
        root = self._roots.setdefault(seed, _RadixNode())
        node, i = root, 0
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                new = _RadixNode(blocks=list(blocks[i:]),
                                 pages=list(page_dicts[i:]), parent=node)
                new.last_use = self._clock
                node.children[new.blocks[0]] = new
                self._index_pages(new)
                return
            j = 0
            while (j < len(child.blocks) and i < len(blocks)
                   and child.blocks[j] == blocks[i]):
                i += 1
                j += 1
            child.last_use = max(child.last_use, self._clock)
            if j == len(child.blocks):
                node = child
                continue
            if i == len(blocks):
                return
            self._split_node(child, j)
            node = child

    def _prune_from(self, node: _RadixNode, bi: int):
        """Remove blocks [bi:] of ``node`` and its whole subtree from the
        index; CACHED pages under the cut are dropped to the free lists."""
        key = node.blocks[0] if node.blocks else None
        for child in list(node.children.values()):
            self._prune_from(child, 0)
        node.children.clear()
        for idx in range(bi, len(node.pages)):
            for name, lps in node.pages[idx].items():
                plane = self.planes[name]
                drop = []
                for lp in lps:
                    lp = int(lp)
                    self._lp_node.pop((name, lp), None)
                    if (plane.aqua.page_refs[lp] == 0
                            and plane.aqua.page_table[lp, 0] != -1):
                        drop.append(lp)
                if drop:
                    plane.aqua.drop_cached(drop)
        del node.pages[bi:]
        del node.blocks[bi:]
        if not node.pages and node.parent is not None and key is not None:
            if node.parent.children.get(key) is node:
                node.parent.children.pop(key)
            node.parent = None

    def _drop_tree_page(self, plane_name: str, lp: int):
        hit = self._lp_node.get((plane_name, int(lp)))
        if hit is not None:
            self._prune_from(hit[0], hit[1])

    def _iter_nodes(self):
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                yield n

    def _block_cached(self, node: _RadixNode, bi: int) -> bool:
        for name, lps in node.pages[bi].items():
            if (self.planes[name].aqua.page_refs[np.asarray(lps, np.int64)]
                    != 0).any():
                return False
        return True

    def _cache_reclaim(self, plane_name: str, tier: int, need: int) -> int:
        """AquaTensor reclaim hook: free ``need`` slots of ``tier`` by
        evicting the coldest cached blocks (deepest first), demoting when
        the next tier down has room. tier -1 asks for outright frees."""
        if not self.caching or self._evicting:
            return 0
        self._evicting = True
        try:
            freed = 0
            while freed < need:
                victim = None
                for node in self._iter_nodes():
                    if not node.pages:
                        continue
                    for bi in range(len(node.pages) - 1, -1, -1):
                        if not self._block_cached(node, bi):
                            break
                        lps = node.pages[bi].get(plane_name)
                        if lps is None:
                            continue
                        tiers = self.planes[plane_name].aqua.page_table[
                            np.asarray(lps, np.int64), 0]
                        if tier != -1 and not (tiers == tier).any():
                            continue
                        if (victim is None
                                or node.last_use < victim[0].last_use):
                            victim = (node, bi)
                        break
                if victim is None:
                    break
                freed += self._evict_block(victim[0], plane_name, tier,
                                           victim[1])
            return freed
        finally:
            self._evicting = False

    def _evict_block(self, node: _RadixNode, plane_name: str, tier: int,
                     bi: int) -> int:
        """Demote cached block ``bi`` of ``node`` one tier down when there
        is room, else free it with its subtree. Returns slots freed in the
        pressured tier."""
        aqua = self.planes[plane_name].aqua
        lps = np.asarray(node.pages[bi][plane_name], np.int64)
        in_tier = lps[aqua.page_table[lps, 0] == tier] if tier != -1 else lps
        room = 0
        if tier == LOCAL:
            room = aqua.remote_free + len(aqua._free_host)
        elif tier == REMOTE:
            room = len(aqua._free_host)
        if 0 < len(in_tier) <= room:
            aqua._move(in_tier, REMOTE if tier == LOCAL else HOST)
            self.cache_demotions += 1
            return len(in_tier)
        freed = len(in_tier)
        self._prune_from(node, bi)
        self.cache_evictions += 1
        return max(freed, 1)

    def cached_pages(self) -> Dict[str, int]:
        """Refcount-0-but-resident pages per plane (the CACHED state)."""
        return {n: int(((p.aqua.page_refs == 0)
                        & (p.aqua.page_table[:, 0] != -1)).sum())
                for n, p in self.planes.items()}

    # -- prefix sharing (refcounted copy-on-write pages) -------------------
    def adopt_prefix(self, rid: int, tokens: Sequence[int],
                     seed: object = None) -> int:
        """Map a new request's block tables onto resident pages for the
        longest common page-aligned prefix of ``tokens``; live blocks are
        retained, cached ones revived (a cache hit). Must precede the
        request's first ``ensure_capacity``. Returns the matched prefix in
        tokens (0 when sharing is off or nothing matches)."""
        if not self.sharing:
            return 0
        blocks = _token_blocks(tokens, self.page_tokens)
        self._req_blocks[rid] = blocks
        self._req_seed[rid] = seed
        matched = self._radix_walk(seed, blocks)
        self._req_registered[rid] = len(matched)
        if not matched:
            return 0
        if any(rid in p.pages for p in self.planes.values()):
            raise ValueError(f"adopt_prefix({rid}) after pages were "
                             "allocated — adoption must precede the first "
                             "ensure_capacity")
        self._clock += 1
        revived_blocks = 0
        for node, bi in matched:
            node.last_use = self._clock
            hit = self._block_cached(node, bi)
            for name, plane in self.planes.items():
                lps = np.asarray(node.pages[bi][name], np.int64)
                if hit:
                    plane.aqua.revive(lps)
                else:
                    refs = plane.aqua.page_refs[lps]
                    cold = lps[refs == 0]
                    if len(cold):
                        plane.aqua.revive(cold)
                    warm = lps[refs > 0]
                    if len(warm):
                        plane.aqua.retain(warm)
                rows = plane.pages.setdefault(
                    rid, [[] for _ in range(plane.n_layers)])
                for l in range(plane.n_layers):
                    rows[l].append(int(lps[l]))
            if hit:
                revived_blocks += 1
        self.prefix_hits += 1
        self.adopted_tokens += len(matched) * self.page_tokens
        if revived_blocks:
            self.cache_hits += 1
            self.cache_hit_tokens += revived_blocks * self.page_tokens
        return len(matched) * self.page_tokens

    def register_prefix(self, rid: int, n_tokens: int):
        """Publish the request's completed full prompt pages (up to
        ``n_tokens`` written positions) into the radix tree."""
        blocks = self._req_blocks.get(rid)
        if not self.sharing or blocks is None:
            return
        n_full = min(n_tokens // self.page_tokens, len(blocks))
        start = self._req_registered.get(rid, 0)
        if n_full <= start:
            return
        page_dicts: List[Dict[str, np.ndarray]] = []
        for p in range(n_full):
            entry: Dict[str, np.ndarray] = {}
            for name, plane in self.planes.items():
                rows = plane.pages.get(rid)
                if rows is None or len(rows[0]) <= p:
                    return
                entry[name] = np.asarray(
                    [rows[l][p] for l in range(plane.n_layers)], np.int64)
            page_dicts.append(entry)
        self._clock += 1
        self._radix_insert(self._req_seed.get(rid), blocks[:n_full],
                           page_dicts)
        self._req_registered[rid] = max(start, n_full)

    def make_writable(self, rid: int, start: int, end: int):
        """Copy-on-write: before the request writes positions ``[start,
        end)``, clone every covered page it shares (or that the radix tree
        indexes) into a fresh LOCAL page and repoint only its own row.

        Raises:
            MemoryError: no LOCAL slot is free for a clone.
        """
        if not self.sharing or end <= start:
            return
        p0, p1 = start // self.page_tokens, (end - 1) // self.page_tokens
        for plane in self.planes.values():
            rows = plane.pages.get(rid)
            if not rows:
                continue
            for row in rows:
                for p in range(p0, min(p1 + 1, len(row))):
                    lp = int(row[p])
                    if (int(plane.aqua.refcounts([lp])[0]) <= 1
                            and (plane.name, lp) not in self._lp_node):
                        continue
                    new = int(plane.aqua.allocate(1, prefer=LOCAL)[0])
                    try:
                        if plane.aqua.page_table[new, 0] != LOCAL:
                            plane.aqua.ensure_local([new])
                    except MemoryError:
                        plane.aqua.free([new])
                        raise
                    plane.aqua.write_local([new], plane.aqua.read([lp]))
                    if rid in self._active:
                        self._unpin(plane, lp)
                        plane.pin[new] = plane.pin.get(new, 0) + 1
                    if self.caching and (plane.name, lp) in self._lp_node:
                        plane.aqua.free_to_cache([lp])
                    else:
                        for f in plane.aqua.free([lp]):
                            self._drop_tree_page(plane.name, f)
                    row[p] = new
                    self.cow_copies += 1

    def shared_pages_with(self, rid: int, other_rids: Sequence[int]
                          ) -> np.ndarray:
        """Per-plane count of this request's pages also referenced by any of
        ``other_rids``."""
        out = []
        for plane in self.planes.values():
            mine = plane.pages.get(rid)
            if not mine:
                out.append(0)
                continue
            mine_set = {lp for row in mine for lp in row}
            shared = set()
            for o in other_rids:
                for row in plane.pages.get(o, []):
                    shared.update(mine_set.intersection(row))
            out.append(len(shared))
        return np.asarray(out, np.int64)

    def prefix_group_of(self, rid: int) -> Optional[object]:
        """Co-scheduling identity: the root-edge radix node of the
        request's prompt (None without indexed coverage)."""
        if not self.sharing:
            return None
        blocks = self._req_blocks.get(rid)
        if not blocks:
            return None
        root = self._roots.get(self._req_seed.get(rid))
        if root is None:
            return None
        return root.children.get(blocks[0])

    def cow_reserve(self) -> np.ndarray:
        """Per-plane pages a pending copy-on-write may allocate (one clone
        per layer row of each token plane)."""
        return np.asarray([p.n_layers if p.kind == "tokens" else 0
                           for p in self.planes.values()], np.int64)

    def physical_pages(self) -> Dict[str, int]:
        return {n: int((p.aqua.page_table[:, 0] != -1).sum())
                for n, p in self.planes.items()}

    def logical_pages(self) -> Dict[str, int]:
        return {n: sum(len(row) for rows in p.pages.values() for row in rows)
                for n, p in self.planes.items()}

    # -- block tables (the step operands) ----------------------------------
    def block_tables_prefill(self, rid: int, pad_to: Optional[int] = None
                             ) -> Dict[str, np.ndarray]:
        """One request's tables from position 0: token planes as host
        (G, n_sub, pad_to) int32 tables of LOCAL slots, scratch-padded;
        state planes as (G, n_sub) bare slots. Chunked prefill passes a
        fixed ``pad_to`` (pps plus the write-window spill) so every chunk's
        window slice stays in bounds."""
        out = {}
        for name, plane in self.planes.items():
            rows = plane.pages[rid]
            tokens = plane.kind == "tokens"
            bt = plane.aqua.block_tables(
                rows, pad_to=(pad_to or len(rows[0])) if tokens else 1,
                pad_slot=plane.scratch_slot)
            out[name] = bt.reshape((self.G, plane.n_sub)
                                   + ((-1,) if tokens else ()))
        return out

    def block_tables(self, lane_rids: Sequence[Optional[int]],
                     pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Packed row query: token planes as host (G, n_sub, B, pad_to)
        int32 tables of LOCAL slots, state planes as (G, n_sub, B); empty
        lanes and padding point at each plane's scratch page."""
        B = len(lane_rids)
        tok_pad = pad_to or self.pps
        out = {}
        for name, plane in self.planes.items():
            rows: List[List[int]] = []
            for l in range(plane.n_layers):
                for rid in lane_rids:
                    rows.append(plane.pages[rid][l] if rid is not None else [])
            tokens = plane.kind == "tokens"
            bt = plane.aqua.block_tables(rows, pad_to=tok_pad if tokens else 1,
                                         pad_slot=plane.scratch_slot)
            out[name] = bt.reshape((self.G, plane.n_sub, B)
                                   + ((tok_pad,) if tokens else ()))
        return out

    # -- tier migration (preempt / restore as page-table flips) ------------
    def park(self, rid: int, n_tokens: int, *, prefer: int = REMOTE):
        """Preempt: flip the request's pages out of LOCAL, every plane in
        one coalesced message per (tier, donor); token pages metered at
        their fill (``n_tokens`` resident positions), state pages whole.
        Shared pages move once: only pages whose pin reaches zero are
        offloaded."""
        with self.meter.coalesce():
            for plane in self.planes.values():
                if rid not in plane.pages:
                    continue
                if plane.kind == "tokens":
                    for row in plane.pages[rid]:
                        fills = np.clip(
                            n_tokens - np.arange(len(row)) * self.page_tokens,
                            0, self.page_tokens) / self.page_tokens
                        fills = np.where(plane.aqua.refcounts(row) > 1, 1.0,
                                         fills)
                        plane.aqua.set_page_fill(row, fills)
                lps = plane.flat(rid)
                if rid in self._active:
                    for lp in lps:
                        self._unpin(plane, int(lp))
                victims = [int(lp) for lp in lps
                           if plane.pin.get(int(lp), 0) == 0]
                if victims:
                    plane.aqua.offload(np.asarray(victims, np.int64),
                                       prefer=prefer)
        self._active.discard(rid)

    def restore(self, rid: int):
        """Make every page of the request LOCAL and pin it there."""
        self._activate(rid)

    def nonlocal_pages(self, rid: int) -> np.ndarray:
        out = []
        for plane in self.planes.values():
            rows = plane.aqua.page_table[plane.flat(rid)]
            out.append(int((rows[:, 0] != LOCAL).sum()) if len(rows) else 0)
        return np.asarray(out, np.int64)

    def local_headroom(self) -> np.ndarray:
        """Per-plane LOCAL slots obtainable without touching live pages."""
        out = []
        for p in self.planes.values():
            free = p.aqua.local_free
            if self.caching:
                free += int(((p.aqua.page_refs == 0)
                             & (p.aqua.page_table[:, 0] == LOCAL)).sum())
            out.append(free)
        return np.asarray(out, np.int64)

    def can_restore(self, rid: int) -> bool:
        """True when a restore fits every plane's obtainable LOCAL slots
        now (the prefetch guard)."""
        return bool(np.all(self.nonlocal_pages(rid) <= self.local_headroom()))

    # -- lease plumbing -----------------------------------------------------
    def add_remote_lease(self, donor: str, nbytes: float):
        """Split a donor's byte grant across the planes in proportion to a
        full-length request's footprint (floored per plane)."""
        weights = {n: float(self._plane_pages(p, self.max_seq)
                            * p.aqua.page_bytes)
                   for n, p in self.planes.items()}
        total = sum(weights.values())
        slots = {n: int(nbytes * weights[n] / total // p.aqua.page_bytes)
                 for n, p in self.planes.items()}
        if not any(slots.values()):
            slots[max(weights, key=weights.get)] = 1
        for name, n_slots in slots.items():
            if n_slots > 0:
                self.planes[name].aqua.add_remote_lease(donor, n_slots)

    def evict_remote(self, donor: str) -> int:
        """Honor a donor reclaim: evacuate every page parked on it to HOST
        and drop the lease. Returns pages moved.

        Raises:
            MemoryError: the host tier cannot absorb the evacuation.
        """
        with self.meter.coalesce():
            return sum(p.aqua.evict_remote(donor)
                       for p in self.planes.values()
                       if donor in p.aqua.remote_pools)

    # -- fault plumbing (lease shrink, donor loss) --------------------------
    def attach_faults(self, faults) -> None:
        """Share one ``core/faults.FaultInjector`` with every plane's
        tensor (transfer-leg retries, lost-donor guards) and the mesh
        domain (lease-boundary guards on its legs)."""
        self.faults = faults
        for plane in self.planes.values():
            plane.aqua.faults = faults
        if self.mesh is not None:
            self.mesh.attach_faults(faults)

    def shrink_lease(self, donor: str, frac: float) -> int:
        """The donor reclaims ``frac`` of its slots in every plane, now.
        Occupied reclaimed slots live-migrate to the other donors or HOST,
        all planes in one coalesced message per (tier, donor). Returns pages
        migrated.

        Raises:
            ValueError: ``frac`` is not in (0, 1].
            LeaseRevokedError: no live lease from this donor in any plane.
            MemoryError: the surviving tiers cannot absorb the migration.
        """
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"shrink fraction {frac} not in (0, 1]")
        holders = [p for p in self.planes.values()
                   if donor in p.aqua.remote_pools]
        if not holders:
            raise LeaseRevokedError(
                f"shrink of donor {donor} without a live lease in any plane",
                donor=donor)
        moved = 0
        with self.meter.coalesce():
            for plane in holders:
                n = math.ceil(frac * plane.aqua.remote_capacity[donor])
                moved += plane.aqua.shrink_lease(donor, n)
        return moved

    def fail_donor(self, donor: str) -> List[int]:
        """Permanent donor loss: every page on the donor (every plane) flips
        to LOST and the leases drop. Radix coverage backed by a lost page is
        pruned now, and CACHED pages on the dead slab are dropped with it.
        Returns the sorted rids whose block tables reference a lost page."""
        victims: set = set()
        for plane in self.planes.values():
            if donor not in plane.aqua.remote_pools:
                continue
            lost = set(int(l) for l in plane.aqua.fail_donor(donor))
            if not lost:
                continue
            for lp in lost:
                self._drop_tree_page(plane.name, lp)
            for rid, rows in plane.pages.items():
                if any(int(lp) in lost for row in rows for lp in row):
                    victims.add(rid)
        if self.faults is not None:
            self.faults.mark_donor_lost(donor)
        return sorted(victims)

    def total_capacity(self) -> np.ndarray:
        """Per-plane physical slots across every live tier (scratch
        excluded): what the runtime can hold at all, LOCAL or parked."""
        return np.asarray(
            [p.aqua.local_pool.shape[0] - 1 + p.aqua.host_pool.shape[0]
             + sum(p.aqua.remote_capacity.values())
             for p in self.planes.values()], np.int64)

    def stats(self) -> Dict:
        """Tier occupancy, transfer-meter totals and sharing/cache
        counters."""
        tiers: Dict[str, int] = {}
        for p in self.planes.values():
            for k, v in p.aqua.tier_counts().items():
                tiers[k] = tiers.get(k, 0) + v
        return {"tiers": tiers,
                "planes": {n: p.aqua.tier_counts()
                           for n, p in self.planes.items()},
                "page_tokens": self.page_tokens,
                "sharing": {"enabled": self.sharing,
                            "prefix_hits": self.prefix_hits,
                            "adopted_tokens": self.adopted_tokens,
                            "cow_copies": self.cow_copies,
                            "physical_pages": self.physical_pages(),
                            "logical_pages": self.logical_pages()},
                "cache": {"enabled": self.caching,
                          "hits": self.cache_hits,
                          "hit_tokens": self.cache_hit_tokens,
                          "evictions": self.cache_evictions,
                          "demotions": self.cache_demotions,
                          "cached_pages": self.cached_pages(),
                          "nodes": sum(1 for _ in self._iter_nodes())},
                "meter": {"bytes_fabric": self.meter.bytes_fabric,
                          "bytes_host": self.meter.bytes_host,
                          "messages_fabric": self.meter.messages_fabric,
                          "messages_host": self.meter.messages_host,
                          "retries_fabric": self.meter.retries_fabric,
                          "retries_host": self.meter.retries_host,
                          "sim_time": self.meter.sim_time}}

    # -- crash-consistent snapshot / restore --------------------------------
    _SNAP_COUNTERS = ("prefix_hits", "adopted_tokens", "cow_copies",
                      "cache_hits", "cache_hit_tokens", "cache_evictions",
                      "cache_demotions")

    def snapshot_state(self) -> Dict:
        """Serialize the runtime's serving state to a plain dict: per-request
        block tables, every referenced page's payload (read from whatever
        tier it sits on, each physical page once however many tables alias
        it), the radix prefix tree with its per-block pages, the prompt
        records behind ``register_prefix`` and the sharing/cache counters.

        Payloads are host numpy arrays, never device tensors: a journal
        record must outlive the process. A plane's ``data`` is its pages in
        ``lps`` order, stored as ``dtype`` says: float32 as float32, bf16
        as its raw 16-bit words (int16, as ``training/checkpoint.py`` stores
        bf16 leaves). The reference's ``req_tokens`` record is absent: the
        port's runtime keeps no per-request prompt copy (the reference
        writes it and reads it only here and in ``restore_state``).

        Logical page ids are snapshot-relative (``restore_state`` remaps
        them). Call between engine steps.

        Raises:
            PageLossError: a referenced page is LOST (recovery must re-queue
                its victim first).
        """
        def ser_node(node: _RadixNode) -> Dict:
            return {"blocks": [list(b) for b in node.blocks],
                    "pages": [{n: [int(x) for x in lps]
                               for n, lps in pd.items()}
                              for pd in node.pages],
                    "last_use": int(node.last_use),
                    "children": [ser_node(c)
                                 for c in node.children.values()]}

        tree_lps: Dict[str, set] = {name: set() for name in self.planes}
        for node in self._iter_nodes():
            for pd in node.pages:
                for n, lps in pd.items():
                    tree_lps[n].update(int(x) for x in lps)
        planes: Dict[str, Dict] = {}
        for name, plane in self.planes.items():
            rows = {int(rid): [[int(lp) for lp in row] for row in rws]
                    for rid, rws in plane.pages.items()}
            lps = sorted({lp for rws in rows.values()
                          for row in rws for lp in row} | tree_lps[name])
            data = None
            if lps:
                data = plane.aqua.read(lps).cpu()
                if data.dtype == torch.bfloat16:
                    data = data.view(torch.int16)
                data = data.numpy()
            planes[name] = {
                "pages": rows, "lps": lps, "data": data,
                "dtype": _dtype_name(plane.aqua.dtype),
                "fills": (plane.aqua.page_fill[
                    np.asarray(lps, np.int64)].tolist() if lps else [])}
        return {
            "version": 1,
            "planes": planes,
            "tree": [{"seed": seed,
                      "children": [ser_node(c)
                                   for c in root.children.values()]}
                     for seed, root in self._roots.items()],
            "req_blocks": {int(r): [list(b) for b in bl]
                           for r, bl in self._req_blocks.items()},
            "req_seed": dict(self._req_seed),
            "req_registered": dict(self._req_registered),
            "clock": int(self._clock),
            "counters": {k: getattr(self, k) for k in self._SNAP_COUNTERS}}

    def restore_state(self, snap: Dict) -> None:
        """Rebuild a :meth:`snapshot_state` dict on a FRESH runtime of the
        same configuration and geometry.

        Every snapshot page is allocated preferring HOST (then a remote
        lease, then LOCAL) and its payload written back verbatim, unmetered.
        Refcounts are rebuilt exactly: one reference per aliasing block
        table, and the CACHED state (refcount 0) for pages only the radix
        index owns. No request is active afterwards; the engine re-queues
        every in-flight request as parked.

        Raises:
            ValueError: this runtime already holds request state, or a
                plane's payload dtype differs from the plane's (checked for
                every plane before anything is written).
        """
        if (any(p.pages for p in self.planes.values()) or self._roots
                or self._active):
            raise ValueError(f"{self.cfg.name}: restore_state on a runtime "
                             "already holding request state — restore "
                             "targets a FRESH engine")
        for name, ps in snap["planes"].items():
            want = _dtype_name(self.planes[name].aqua.dtype)
            if ps["dtype"] != want:
                raise ValueError(f"{self.cfg.name}/{name}: snapshot payload "
                                 f"is {ps['dtype']}, the plane holds {want}")
        maps: Dict[str, Dict[int, int]] = {}
        for name, ps in snap["planes"].items():
            plane = self.planes[name]
            ref_rids: Dict[int, set] = {}
            for rid, rws in ps["pages"].items():
                for row in rws:
                    for lp in row:
                        ref_rids.setdefault(int(lp), set()).add(int(rid))
            lp_map: Dict[int, int] = {}
            old_lps = [int(x) for x in ps["lps"]]
            if old_lps:
                data = torch.from_numpy(np.ascontiguousarray(ps["data"]))
                if ps["dtype"] == "bfloat16":
                    data = data.view(torch.bfloat16)
                new = plane.aqua.allocate(len(old_lps), prefer=HOST)
                plane.aqua.write(new, data, meter=False)
                plane.aqua.set_page_fill(new, np.asarray(ps["fills"]))
                cached: List[int] = []
                for old, nlp in zip(old_lps, new):
                    nlp = int(nlp)
                    lp_map[old] = nlp
                    k = len(ref_rids.get(old, ()))
                    if k == 0:
                        cached.append(nlp)   # tree-owned: CACHED, ref 0
                    for _ in range(k - 1):   # one ref per aliasing table
                        plane.aqua.retain([nlp])
                if cached:
                    plane.aqua.free_to_cache(cached)
            for rid, rws in ps["pages"].items():
                plane.pages[int(rid)] = [[lp_map[int(lp)] for lp in row]
                                         for row in rws]
            maps[name] = lp_map

        def build(d: Dict, parent: _RadixNode) -> _RadixNode:
            node = _RadixNode(
                blocks=[tuple(int(t) for t in b) for b in d["blocks"]],
                pages=[{n: np.asarray([maps[n][int(x)] for x in lps],
                                      np.int64)
                        for n, lps in pd.items()} for pd in d["pages"]],
                parent=parent)
            node.last_use = int(d["last_use"])
            for cd in d["children"]:
                c = build(cd, node)
                node.children[c.blocks[0]] = c
            return node

        for entry in snap["tree"]:
            root = _RadixNode()
            for cd in entry["children"]:
                c = build(cd, root)
                root.children[c.blocks[0]] = c
            self._roots[entry["seed"]] = root
        for node in self._iter_nodes():
            for bi, pd in enumerate(node.pages):
                for n, lps in pd.items():
                    for lp in lps:
                        self._lp_node[(n, int(lp))] = (node, bi)
        self._req_blocks = {int(r): [tuple(int(t) for t in b) for b in bl]
                            for r, bl in snap["req_blocks"].items()}
        self._req_seed = dict(snap["req_seed"])
        self._req_registered = {int(r): int(v)
                                for r, v in snap["req_registered"].items()}
        self._clock = int(snap["clock"])
        for k in self._SNAP_COUNTERS:
            setattr(self, k, snap["counters"][k])


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: how a snapshot names a
    plane's payload type."""
    return str(dtype).rsplit(".", 1)[-1]
