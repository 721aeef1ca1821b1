"""AQUA TENSORS — tiered paged tensors (paper §3), single-device backend.

A logical paged tensor whose pages physically live in one of three tiers:

  LOCAL   the serving card's own page pool (the operand of the paged
          attention kernel)
  REMOTE  a donor's memory reached over the scale-up fabric. Transfers are
          COALESCED: the kv_gather kernel packs the victim pages into one
          contiguous staging buffer that moves as a single message.
  HOST    host DRAM over PCIe (pinned when the device is CUDA).

The bookkeeping is the reference's (``repro/core/aqua_tensor.py``) and stays
in numpy under the same attribute names: ``page_table``, ``page_refs``,
``page_fill``, the free lists and the CACHED state (refcount 0, slot kept).
The LOCAL and REMOTE pools are tensors on the serving device — a donor lease
is a slab on that device, as in the reference's single-device backend — and
every tier move is a gather into staging plus a scatter, through
``kernels/kv_gather``. Every movement is metered by ``TransferMeter`` and
priced by ``core/perfmodel.py``.

Donors are mortal (``core/faults.py``): an attached ``FaultInjector`` is
consulted before every transfer leg (transient failures retry with priced
backoff), a donor may shrink its lease (``shrink_lease``: the reclaimed
slots' pages live-migrate elsewhere) or die (``fail_donor``: its pages flip
to the LOST tier, and touching them raises ``PageLossError``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.errors import (AquaError, LeaseRevokedError,
                                     PageLossError, TransferFaultError)
from repro_torch.core.perfmodel import (H100_SXM, HardwareProfile,
                                        retry_backoff_time)
from repro_torch.kernels.kv_gather import ops as kv_ops

LOCAL, REMOTE, HOST = 0, 1, 2
# LOST: the page's only copy was on a donor that died (``fail_donor``). Lost
# pages keep their refcounts until recovery releases them; any read or move
# of one raises PageLossError.
LOST = 3
TIER_NAMES = {LOCAL: "local", REMOTE: "remote", HOST: "host", LOST: "lost"}


@dataclass
class TransferMeter:
    """Accounting for every page movement; priced by the perf model.

    ``coalesce()`` opens a cross-plane transaction: every ``record`` inside
    it accumulates bytes per ``(tier, group)`` key and the transaction
    emits ONE message per key on exit."""
    hw: HardwareProfile = H100_SXM
    bytes_fabric: float = 0.0
    bytes_host: float = 0.0
    messages_fabric: int = 0
    messages_host: int = 0
    # failed-then-retried leg attempts (fault injection): priced like a
    # message plus backoff, counted apart from the messages
    retries_fabric: int = 0
    retries_host: int = 0
    sim_time: float = 0.0
    _txn: Optional[Dict] = field(default=None, repr=False, compare=False)

    def record(self, nbytes: float, tier: int, group=None):
        """One message of ``nbytes`` on ``tier``'s link, or, inside a
        transaction, bytes added to the ``(tier, group)`` message."""
        if self._txn is not None:
            self._txn[(tier, group)] = self._txn.get((tier, group), 0.0) \
                + nbytes
            return
        link = self.hw.fabric if tier == REMOTE else self.hw.host_link
        if tier == REMOTE:
            self.bytes_fabric += nbytes
            self.messages_fabric += 1
        else:
            self.bytes_host += nbytes
            self.messages_host += 1
        self.sim_time += link.time(nbytes)

    def record_retry(self, nbytes: float, tier: int, n_pages: int,
                     attempt: int):
        """Price one failed transfer-leg attempt: the wasted message time
        plus exponential backoff. Bypasses any open transaction and counts
        in ``retries_*``, never ``messages_*``. (Messages are coalesced, so
        ``n_pages`` does not change the count.)"""
        link = self.hw.fabric if tier == REMOTE else self.hw.host_link
        if tier == REMOTE:
            self.retries_fabric += 1
        else:
            self.retries_host += 1
        self.sim_time += (link.time(nbytes)
                          + retry_backoff_time(self.hw, attempt))

    def coalesce(self):
        """Context manager fusing every ``record`` inside it into one
        message per ``(tier, group)`` key (reentrant: the outermost
        transaction wins)."""
        return _MeterTxn(self)


class _MeterTxn:
    def __init__(self, meter: TransferMeter):
        self.meter = meter
        self.outer = False

    def __enter__(self):
        if self.meter._txn is not None:
            self.outer = True           # nested: fold into the outer txn
            return self.meter
        self.meter._txn = {}
        return self.meter

    def __exit__(self, exc_type, exc, tb):
        if self.outer:
            return False
        txn, self.meter._txn = self.meter._txn, None
        for (tier, _group), nbytes in txn.items():
            self.meter.record(nbytes, tier)
        return False


class AquaTensor:
    """A paged tensor with tiered page placement. Page payload:
    ``page_shape``. The LOCAL and REMOTE pools live on ``device`` (CUDA
    unless the caller passes another; raises when CUDA is absent)."""

    def __init__(self, *, n_logical: int, page_shape: Tuple[int, ...],
                 local_slots: int, host_slots: int,
                 dtype: torch.dtype = torch.bfloat16,
                 meter: Optional[TransferMeter] = None, name: str = "kv",
                 device=None, faults=None):
        self.name = name
        self.device = resolve_device(device)
        # optional core/faults.FaultInjector, consulted before every
        # transfer leg and at lease boundaries
        self.faults = faults
        self.page_shape = tuple(page_shape)
        self.dtype = dtype
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.page_bytes = int(np.prod(page_shape)) * itemsize
        self.local_pool = torch.zeros((local_slots,) + self.page_shape,
                                      dtype=dtype, device=self.device)
        self.host_pool = torch.zeros(
            (host_slots,) + self.page_shape, dtype=dtype,
            pin_memory=self.device.type == "cuda")
        self.remote_pools: Dict[str, torch.Tensor] = {}
        self._remote_free: Dict[str, List[int]] = {}
        # page_table[lp] = (tier, slot, donor_idx) ; -1 = unallocated
        self.page_table = np.full((n_logical, 3), -1, np.int64)
        # references per logical page (copy-on-write prefix sharing): the
        # physical slot is released only when the LAST reference is freed
        self.page_refs = np.zeros((n_logical,), np.int64)
        # valid fraction of each page payload: partial tails are metered at
        # their live bytes only
        self.page_fill = np.ones((n_logical,), np.float64)
        self._free_local = list(range(local_slots))[::-1]
        self._free_host = list(range(host_slots))[::-1]
        self._donors: List[str] = []
        self.remote_capacity: Dict[str, int] = {}
        self.meter = meter or TransferMeter()
        # CACHED pages (refcount 0, still resident) yield through this hook
        # ``reclaim(tier, need) -> freed`` before any allocation fails
        self.reclaim = None
        self._reclaiming = False

    def _ids(self, slots) -> torch.Tensor:
        """Pool slot ids as an int32 index tensor on the serving device."""
        return torch.as_tensor(np.asarray(slots, np.int32)).to(self.device)

    def _try_reclaim(self, tier: int, need: int) -> int:
        if self.reclaim is None or self._reclaiming:
            return 0
        self._reclaiming = True
        try:
            return int(self.reclaim(tier, need))
        finally:
            self._reclaiming = False

    # ------------------------------------------------------------------
    # lease management
    # ------------------------------------------------------------------
    def add_remote_lease(self, donor: str, slots: int):
        """Donor offered ``slots`` pages of its memory. A donor evicted
        earlier may re-lease: its ``_donors`` entry is reused.

        Raises:
            ValueError: the donor already holds a live lease here.
            LeaseRevokedError: the donor was marked permanently lost.
        """
        if donor in self.remote_pools:
            raise ValueError(f"{self.name}: donor {donor} already holds a "
                             "live lease (evict before re-leasing)")
        if self.faults is not None and self.faults.donor_lost(donor):
            raise LeaseRevokedError(
                f"{self.name}: donor {donor} is permanently lost and cannot "
                "offer a lease", donor=donor)
        self.remote_pools[donor] = torch.zeros(
            (slots,) + self.page_shape, dtype=self.dtype, device=self.device)
        self._remote_free[donor] = list(range(slots))[::-1]
        self.remote_capacity[donor] = int(slots)
        if donor not in self._donors:
            self._donors.append(donor)

    def evict_remote(self, donor: str) -> int:
        """Donor reclaims its lease: evacuate pages to host, drop the pool."""
        moved = 0
        victims = np.nonzero((self.page_table[:, 0] == REMOTE)
                             & (self.page_table[:, 2]
                                == self._donors.index(donor)))[0]
        if len(victims):
            self._move(victims, HOST)
            moved = len(victims)
        self._drop_lease(donor)
        return moved

    def _drop_lease(self, donor: str):
        """Forget a donor's pool; it stays in ``_donors`` so the indices of
        the others stay stable."""
        del self.remote_pools[donor]
        del self._remote_free[donor]
        del self.remote_capacity[donor]

    def shrink_lease(self, donor: str, n_slots: int) -> int:
        """Donor reclaims its TOP ``n_slots`` slots now. Occupied reclaimed
        slots live-migrate to the other donors or HOST, never back onto the
        shrinking donor; free ones leave the free list. A shrink to zero
        drops the lease. Returns pages migrated.

        Raises:
            LeaseRevokedError: no live lease from this donor.
            MemoryError: the surviving tiers cannot absorb the migration.
        """
        if donor not in self.remote_pools:
            raise LeaseRevokedError(
                f"{self.name}: shrink of donor {donor} without a live lease",
                donor=donor)
        cap = self.remote_capacity[donor]
        n = int(min(max(n_slots, 0), cap))
        if n == 0:
            return 0
        lo = cap - n
        di = self._donors.index(donor)
        victims = np.nonzero((self.page_table[:, 0] == REMOTE)
                             & (self.page_table[:, 2] == di)
                             & (self.page_table[:, 1] >= lo))[0]
        if len(victims):
            self._move(victims, REMOTE, exclude_donor=donor)
        self._remote_free[donor] = [s for s in self._remote_free[donor]
                                    if s < lo]
        self.remote_capacity[donor] = lo
        if lo == 0:
            self._drop_lease(donor)
        return len(victims)

    def fail_donor(self, donor: str) -> np.ndarray:
        """Permanent donor loss: every page resident on it flips to LOST
        (refcounts kept until recovery releases them), the lease drops and
        the injector marks the donor lost. Returns the lost logical ids."""
        if donor not in self.remote_pools:
            return np.zeros((0,), np.int64)
        di = self._donors.index(donor)
        lost = np.nonzero((self.page_table[:, 0] == REMOTE)
                          & (self.page_table[:, 2] == di))[0]
        self.page_table[lost, 0] = LOST
        self._drop_lease(donor)
        if self.faults is not None:
            self.faults.mark_donor_lost(donor)
        return lost

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------
    def allocate(self, n: int, prefer: int = LOCAL) -> np.ndarray:
        """Allocate n logical pages (preferred tier first, then fallbacks),
        each with refcount 1. All-or-nothing.

        Raises:
            MemoryError: out of logical page ids, or every tier is full.
        """
        free_lp = np.nonzero(self.page_table[:, 0] == -1)[0]
        if len(free_lp) < n:
            self._try_reclaim(-1, n - len(free_lp))
            free_lp = np.nonzero(self.page_table[:, 0] == -1)[0]
        if len(free_lp) < n:
            raise MemoryError(f"{self.name}: out of logical pages")
        lps = free_lp[:n]
        taken: List[int] = []
        try:
            for lp in lps:
                tier, slot, donor = self._take_slot(prefer)
                self.page_table[lp] = (tier, slot, donor)
                taken.append(int(lp))
        except MemoryError:
            self._release_slots(taken)
            raise
        self.page_fill[lps] = 1.0
        self.page_refs[lps] = 1
        return lps

    def _free_slot_of(self, lp: int):
        tier, slot, donor = self.page_table[lp]
        if tier == LOCAL:
            self._free_local.append(int(slot))
        elif tier == HOST:
            self._free_host.append(int(slot))
        elif tier == REMOTE:
            self._remote_free[self._donors[donor]].append(int(slot))
        # LOST: the slot's pool is gone, nothing to hand back
        self.page_table[lp] = (-1, -1, -1)
        self.page_fill[lp] = 1.0

    def _release_slots(self, lps: Sequence[int]):
        """Allocation rollback: return not-yet-reffed pages' slots."""
        for lp in lps:
            self._free_slot_of(lp)
            self.page_refs[lp] = 0

    def retain(self, lps: Sequence[int]):
        """Add one reference to each listed page."""
        lps = np.asarray(lps, np.int64)
        if (self.page_refs[lps] < 1).any():
            bad = [int(l) for l in lps if self.page_refs[l] < 1]
            raise ValueError(f"{self.name}: retain of unallocated pages {bad}")
        self.page_refs[lps] += 1

    def refcounts(self, lps: Sequence[int]) -> np.ndarray:
        return self.page_refs[np.asarray(lps, np.int64)].copy()

    def free(self, lps: Sequence[int]) -> List[int]:
        """Drop one reference per listed page; release the slot of pages
        whose count reaches zero. Returns the logical ids actually freed."""
        freed: List[int] = []
        for lp in lps:
            if self.page_refs[lp] > 1:
                self.page_refs[lp] -= 1
                continue
            self._free_slot_of(lp)
            self.page_refs[lp] = 0
            freed.append(int(lp))
        return freed

    # ------------------------------------------------------------------
    # CACHED state: refcount 0, still resident (global prefix cache)
    # ------------------------------------------------------------------
    def free_to_cache(self, lps: Sequence[int]) -> List[int]:
        """Drop one reference per page but KEEP the slot of pages whose
        count reaches zero (CACHED). Returns the ids that became cached. A
        LOST page cannot be cached (its payload is gone): it is freed."""
        cached: List[int] = []
        for lp in lps:
            if self.page_refs[lp] > 1:
                self.page_refs[lp] -= 1
                continue
            self.page_refs[lp] = 0
            if self.page_table[lp, 0] == LOST:
                self._free_slot_of(lp)
                continue
            cached.append(int(lp))
        return cached

    def revive(self, lps: Sequence[int]):
        """Cache hit: refcount 0 -> 1 on CACHED pages only."""
        lps = np.asarray(lps, np.int64)
        bad = [int(l) for l in lps
               if self.page_refs[l] != 0 or self.page_table[l, 0] == -1]
        if bad:
            raise ValueError(f"{self.name}: revive of non-cached pages {bad}")
        self.page_refs[lps] = 1

    def drop_cached(self, lps: Sequence[int]) -> List[int]:
        """Evict CACHED pages: hand their slots back to the free lists."""
        dropped: List[int] = []
        for lp in lps:
            if self.page_refs[lp] != 0 or self.page_table[lp, 0] == -1:
                raise ValueError(
                    f"{self.name}: drop_cached of non-cached page {int(lp)}")
            self._free_slot_of(lp)
            dropped.append(int(lp))
        return dropped

    def set_page_fill(self, lps: Sequence[int], frac):
        """Declare the valid fraction of each page payload (partial tails)."""
        self.page_fill[np.asarray(lps, np.int64)] = np.clip(frac, 0.0, 1.0)

    def _take_slot(self, prefer: int = LOCAL) -> Tuple[int, int, int]:
        order = {LOCAL: [LOCAL, REMOTE, HOST], REMOTE: [REMOTE, HOST, LOCAL],
                 HOST: [HOST, REMOTE, LOCAL]}[prefer]
        for tier in order:
            if tier == LOCAL:
                if not self._free_local:
                    self._try_reclaim(LOCAL, 1)
                if self._free_local:
                    return LOCAL, self._free_local.pop(), -1
            if tier == REMOTE:
                for di, d in enumerate(self._donors):
                    if d in self._remote_free and self._remote_free[d]:
                        return REMOTE, self._remote_free[d].pop(), di
            if tier == HOST:
                if not self._free_host:
                    self._try_reclaim(HOST, 1)
                if self._free_host:
                    return HOST, self._free_host.pop(), -1
        raise MemoryError(f"{self.name}: all tiers full")

    # ------------------------------------------------------------------
    # tier legs (fault-guarded)
    # ------------------------------------------------------------------
    def _leg_guard(self, tier: int, donor: Optional[str], n_pages: int):
        """Consult the fault injector before a transfer leg: each failed
        attempt is priced (``record_retry``) and retried; the injector's
        streak cap makes the retries converge.

        Raises:
            LeaseRevokedError: the addressed donor is permanently lost.
            TransferFaultError: the leg failed ``max_leg_retries`` times in
                a row.
        """
        f = self.faults
        if f is None:
            return
        if f.donor_lost(donor):
            raise LeaseRevokedError(
                f"{self.name}: transfer leg addressed lost donor {donor}",
                donor=donor)
        nbytes = float(n_pages) * self.page_bytes
        attempt = 0
        while f.leg_fails(tier, donor):
            attempt += 1
            self.meter.record_retry(nbytes, tier, n_pages, attempt)
            if attempt >= f.max_leg_retries:
                raise TransferFaultError(
                    f"{self.name}: {TIER_NAMES[tier]} leg"
                    f"{' to ' + donor if donor else ''} failed "
                    f"{attempt} consecutive attempts (retry budget "
                    f"{f.max_leg_retries})", tier=tier, donor=donor,
                    attempts=attempt)

    def _live_pool(self, donor: str, op: str) -> torch.Tensor:
        if donor not in self.remote_pools:
            raise LeaseRevokedError(
                f"{self.name}: {op} donor {donor} without a live lease",
                donor=donor)
        return self.remote_pools[donor]

    def _remote_gather(self, donor: str, slots) -> torch.Tensor:
        """Pull ``slots`` out of a donor pool as one contiguous staging
        batch."""
        pool = self._live_pool(donor, "gather from")
        self._leg_guard(REMOTE, donor, len(slots))
        return kv_ops.gather_pages(pool, self._ids(slots))

    def _remote_scatter(self, donor: str, slots, data: torch.Tensor):
        """Push a contiguous staging batch into a donor pool at ``slots``."""
        pool = self._live_pool(donor, "scatter to")
        self._leg_guard(REMOTE, donor, len(slots))
        kv_ops.scatter_pages(pool, data.to(self.dtype), self._ids(slots))

    def _host_gather(self, slots) -> torch.Tensor:
        rows = self.host_pool[torch.as_tensor(np.asarray(slots, np.int64))]
        return rows.to(self.device, non_blocking=True)

    def _host_scatter(self, slots, data: torch.Tensor):
        self.host_pool[torch.as_tensor(np.asarray(slots, np.int64))] = \
            data.to(self.dtype).cpu()

    # ------------------------------------------------------------------
    # data access
    # ------------------------------------------------------------------
    def write_local(self, lps: Sequence[int], data: torch.Tensor):
        """Write page payloads for LOCAL-resident logical pages."""
        slots = self._slots_of(lps, LOCAL)
        kv_ops.scatter_pages(self.local_pool,
                             data.to(self.device, self.dtype),
                             self._ids(slots))

    def write(self, lps: Sequence[int], data: torch.Tensor, *,
              meter: bool = True):
        """Write page payloads wherever the pages live; each non-local group
        is one coalesced (metered) transfer. ``data`` may sit on the host or
        the device: each group crosses to its tier's memory once (host
        payloads bound for HOST never touch the device)."""
        data = data.to(dtype=self.dtype)
        rows = self.page_table[np.asarray(lps, np.int64)]
        for tier in (LOCAL, REMOTE, HOST):
            idx = np.nonzero(rows[:, 0] == tier)[0]
            if not len(idx):
                continue
            part = data[torch.as_tensor(idx, device=data.device)]
            if tier == LOCAL:
                kv_ops.scatter_pages(self.local_pool, part.to(self.device),
                                     self._ids(rows[idx, 1]))
                continue
            if tier == REMOTE:
                for di in np.unique(rows[idx, 2]):
                    sel = rows[idx, 2] == di
                    sub = idx[sel]
                    sub_data = part[torch.as_tensor(np.nonzero(sel)[0],
                                                    device=data.device)]
                    self._remote_scatter(self._donors[int(di)], rows[sub, 1],
                                         sub_data.to(self.device))
                    if meter:
                        self.meter.record(len(sub) * self.page_bytes, REMOTE)
            else:
                self._leg_guard(HOST, None, len(idx))
                self._host_scatter(rows[idx, 1], part)
                if meter:
                    self.meter.record(len(idx) * self.page_bytes, HOST)

    def read(self, lps: Sequence[int], *, meter: bool = False
             ) -> torch.Tensor:
        """Gather page payloads regardless of tier (does not migrate), one
        gather per (tier, donor) group, reassembled into request order.
        ``meter=True`` prices the non-local groups as coalesced page-ins."""
        lps = np.asarray(lps, np.int64)
        rows = self.page_table[lps]
        if len(lps) == 0:
            return torch.zeros((0,) + self.page_shape, dtype=self.dtype,
                               device=self.device)
        self._check_not_lost(lps, rows, "read")
        parts: List[torch.Tensor] = []
        order: List[np.ndarray] = []
        for tier in (LOCAL, REMOTE, HOST):
            idx = np.nonzero(rows[:, 0] == tier)[0]
            if not len(idx):
                continue
            if tier == LOCAL:
                parts.append(kv_ops.gather_pages(self.local_pool,
                                                 self._ids(rows[idx, 1])))
                order.append(idx)
            elif tier == HOST:
                self._leg_guard(HOST, None, len(idx))
                parts.append(self._host_gather(rows[idx, 1]))
                order.append(idx)
            else:
                for di in np.unique(rows[idx, 2]):
                    sub = idx[rows[idx, 2] == di]
                    parts.append(self._remote_gather(self._donors[int(di)],
                                                     rows[sub, 1]))
                    order.append(sub)
        combined = torch.cat(parts, dim=0)
        positions = np.concatenate(order)
        out = combined[torch.as_tensor(np.argsort(positions, kind="stable"),
                                       device=self.device)]
        if meter:
            fills = self.page_fill[lps]
            for tier in (REMOTE, HOST):
                idx = np.nonzero(rows[:, 0] == tier)[0]
                if len(idx):
                    self.meter.record(float(fills[idx].sum())
                                      * self.page_bytes, tier)
        return out

    def block_tables(self, lps_rows: Sequence[Sequence[int]], pad_to: int,
                     *, pad_slot: int = 0) -> np.ndarray:
        """Physical LOCAL slots of each row's logical pages as one padded
        (B, pad_to) int32 table; padding points at ``pad_slot``."""
        out = np.full((len(lps_rows), pad_to), pad_slot, np.int32)
        for b, lps in enumerate(lps_rows):
            if len(lps) == 0:
                continue
            if len(lps) > pad_to:
                raise ValueError(f"{self.name}: row {b} has {len(lps)} pages"
                                 f" > pad_to={pad_to}")
            rows = self.page_table[np.asarray(lps, np.int64)]
            if not (rows[:, 0] == LOCAL).all():
                self._check_not_lost(lps, rows, "block-table build")
                bad = [int(l) for l, r in zip(lps, rows) if r[0] != LOCAL]
                raise ValueError(f"{self.name}: pages {bad} not LOCAL; "
                                 "ensure_local before building block tables")
            out[b, :len(lps)] = rows[:, 1]
        return out

    def _slots_of(self, lps, tier) -> np.ndarray:
        rows = self.page_table[np.asarray(lps, np.int64)]
        if not (rows[:, 0] == tier).all():
            bad = [int(l) for l, r in zip(lps, rows) if r[0] != tier]
            raise ValueError(f"pages {bad} not in tier {TIER_NAMES[tier]}")
        return rows[:, 1].astype(np.int32)

    # ------------------------------------------------------------------
    # migration (the AQUA mechanism)
    # ------------------------------------------------------------------
    def ensure_local(self, lps: Sequence[int]):
        """Page-in: make all listed logical pages LOCAL (coalesced per
        tier).

        Raises:
            PageLossError: a listed page is LOST.
        """
        lps = np.asarray(lps, np.int64)
        rows = self.page_table[lps]
        self._check_not_lost(lps, rows, "ensure_local")
        for tier in (REMOTE, HOST):
            sel = lps[rows[:, 0] == tier]
            if len(sel):
                self._move(sel, LOCAL)

    def offload(self, lps: Sequence[int], *, prefer: int = REMOTE):
        """Page-out LOCAL pages to the fast remote tier (host as
        fallback).

        Raises:
            PageLossError: a listed page is LOST (skipping it would hide a
                donor's death from the park path).
        """
        lps = np.asarray(lps, np.int64)
        rows = self.page_table[lps]
        self._check_not_lost(lps, rows, "offload")
        sel = lps[rows[:, 0] == LOCAL]
        if len(sel):
            self._move(sel, prefer)

    def _check_not_lost(self, lps, rows, op: str):
        """Touching a LOST page raises the typed loss, the engine's cue to
        recompute the request from its prompt."""
        lost = [int(l) for l, r in zip(lps, rows) if r[0] == LOST]
        if lost:
            raise PageLossError(
                f"{self.name}: {op} of page(s) {lost[:8]} whose donor died "
                "holding the only copy", plane=self.name, pages=lost)

    def _move(self, lps: np.ndarray, dst_tier: int,
              exclude_donor: Optional[str] = None):
        """Coalesced migration of a batch of pages between tiers, atomic per
        (source tier, donor) group: destination slots are acquired and
        written before any source slot is freed, and a failed placement
        (a tier exhausted, a leg fault, a revoked lease) hands every
        acquired slot back, leaving the page table and free lists as they
        were. ``exclude_donor`` is never a REMOTE destination (a shrinking
        donor must not take back the pages it reclaims).

        Raises:
            PageLossError: a listed page is LOST.
        """
        rows = self.page_table[lps]
        self._check_not_lost(lps, rows, "migration")
        groups: Dict[Tuple[int, int], List[int]] = {}
        for lp, (tier, slot, donor) in zip(lps, rows):
            groups.setdefault((int(tier), int(donor)), []).append(int(lp))
        for (src_tier, src_donor), group in groups.items():
            slots = self.page_table[group, 1].astype(np.int32)
            # 1) coalescing gather into one contiguous staging buffer; the
            # source slots stay allocated until the group has landed
            if src_tier == LOCAL:
                staging = kv_ops.gather_pages(self.local_pool,
                                              self._ids(slots))
            elif src_tier == REMOTE:
                staging = self._remote_gather(self._donors[src_donor], slots)
            else:
                self._leg_guard(HOST, None, len(slots))
                staging = self._host_gather(slots)
            fills = self.page_fill[group] * self.page_bytes
            transfer_tier = (REMOTE if (src_tier == REMOTE
                                        or dst_tier == REMOTE) else HOST)
            src_name = self._donors[src_donor] if src_donor >= 0 else None

            def meter(lo, hi, dst, dst_name):
                if dst_tier == src_tier or hi <= lo:
                    return
                self.meter.record(float(fills[lo:hi].sum()), transfer_tier,
                                  group=(src_tier, src_name, dst, dst_name))

            # 2) acquire destination slots and scatter; roll back on failure
            new_rows = []
            popped: List[Tuple[List[int], int]] = []
            try:
                if dst_tier == LOCAL:
                    dst_slots = [self._pop_free(self._free_local, LOCAL,
                                                len(group))
                                 for _ in group]
                    popped += [(self._free_local, s) for s in dst_slots]
                    kv_ops.scatter_pages(self.local_pool, staging,
                                         self._ids(dst_slots))
                    new_rows = [(LOCAL, s, -1) for s in dst_slots]
                    meter(0, len(group), LOCAL, None)
                elif dst_tier == REMOTE:
                    placed = 0
                    for di, d in enumerate(self._donors):
                        if d == exclude_donor:
                            continue
                        free = self._remote_free.get(d, [])
                        take = min(len(free), len(group) - placed)
                        if take <= 0:
                            continue
                        dst_slots = [free.pop() for _ in range(take)]
                        popped += [(free, s) for s in dst_slots]
                        self._remote_scatter(d, dst_slots,
                                             staging[placed:placed + take])
                        new_rows += [(REMOTE, s, di) for s in dst_slots]
                        meter(placed, placed + take, REMOTE, d)
                        placed += take
                    if placed < len(group):      # remote full -> host
                        need = len(group) - placed
                        self._leg_guard(HOST, None, need)
                        dst_slots = [self._pop_free(self._free_host, HOST,
                                                    need)
                                     for _ in range(need)]
                        popped += [(self._free_host, s) for s in dst_slots]
                        self._host_scatter(dst_slots, staging[placed:])
                        new_rows += [(HOST, s, -1) for s in dst_slots]
                        meter(placed, len(group), HOST, None)
                else:
                    self._leg_guard(HOST, None, len(group))
                    dst_slots = [self._pop_free(self._free_host, HOST,
                                                len(group))
                                 for _ in group]
                    popped += [(self._free_host, s) for s in dst_slots]
                    self._host_scatter(dst_slots, staging)
                    new_rows = [(HOST, s, -1) for s in dst_slots]
                    meter(0, len(group), HOST, None)
            except (MemoryError, AquaError):
                for free_list, s in popped:
                    free_list.append(s)
                raise
            # 3) the whole group landed: free the source slots, repoint rows
            if src_tier == LOCAL:
                self._free_local.extend(int(s) for s in slots)
            elif src_tier == REMOTE:
                self._remote_free[src_name].extend(int(s) for s in slots)
            else:
                self._free_host.extend(int(s) for s in slots)
            for lp, row in zip(group, new_rows):
                self.page_table[lp] = row

    def _pop_free(self, free_list: List[int], tier: int, need: int) -> int:
        """Take one destination slot; cached pages yield first.

        Raises:
            MemoryError: the tier is exhausted past reclaim.
        """
        if not free_list:
            self._try_reclaim(tier, need)
        if not free_list:
            raise MemoryError(
                f"{self.name}: {TIER_NAMES[tier]} tier exhausted while "
                f"migrating pages (needed {need} free slot(s))")
        return free_list.pop()

    # ------------------------------------------------------------------
    def tier_counts(self) -> Dict[str, int]:
        t = self.page_table[:, 0]
        out = {TIER_NAMES[k]: int((t == k).sum())
               for k in (LOCAL, REMOTE, HOST)}
        n_lost = int((t == LOST).sum())
        if n_lost:                    # only while a loss is unrecovered
            out["lost"] = n_lost
        return out

    @property
    def local_free(self) -> int:
        return len(self._free_local)

    @property
    def remote_free(self) -> int:
        return sum(len(v) for v in self._remote_free.values())
