"""Mesh-real memory tiers: donor page pools resident on PEER devices —
``repro/distributed/mesh_tiers.py`` in the port.

The REMOTE tier stops being a slab on the serving device and becomes a
slab of a peer device's memory. ``MeshTierDomain`` owns a list of the
scale-up domain's devices (the paper's NVLink clique: every CUDA device by
default). Entry 0 is the SERVING device; every other entry is a potential
donor. A donor lease (``AquaTensor.add_remote_lease``) allocates a real
slab on the donor's device, and each transfer leg is one copy across the
fabric:

  push (offload / park)    pad the coalesced page batch to its bucket on
                           the serving device, ONE ``copy_`` into a
                           staging buffer on the donor, then scatter into
                           the donor's slab there (kv_gather's
                           ``scatter_pages``, in place)
  pull (ensure_local)      gather the bucket-padded slots on the donor
                           (``gather_pages``), ONE ``copy_`` to the
                           serving device

So each (plane, tier, donor) leg of a tier flip is exactly one message on
the wire — ``collectives`` counts them, one a leg, in lockstep with the
``TransferMeter``'s priced messages. Page counts pad to power-of-two
buckets, as in the reference (whose legs are compiled per bucket).

Every leg is timed wall to wall, from its dispatch until its output is
ready (an event on the output device's current stream, waited for as
``block_until_ready`` waits in the reference; nothing is drained before
the leg); the first call of each key ``(direction, device, bucket, S,
page_shape, dtype)`` is not sampled, as the reference skips its compile,
so one sequence of moves gives the reference's counts and sample bytes.
The samples feed ``perfmodel.calibrate_profile``
(``ServingEngine.calibrate_clock``).

Divergences from the reference: a leg is a plain copy, not a
``shard_map``ped ``ppermute``, so ``shard_map_compat`` has no counterpart
and the domain has no ``axis`` name and no ``mesh`` attribute (they only
named the ``ppermute`` axis);
the pool is the donor's ``(slots + 1, *page)`` slab alone on its device,
not a ``(n_dev, slots + 1, *page)`` array with every other device's unused
rows; and an explicit device list may repeat a device (four CPU entries on
the CPU, ``[cuda:0, cuda:0]`` on a one-card machine), the counterpart of
XLA's forced host devices — there the "peer" slab shares the serving
device's memory and a leg is a same-memory copy.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.errors import LeaseRevokedError
from repro_torch.kernels.kv_gather import ops as kv_ops


def _bucket(n: int) -> int:
    """Power-of-two shape bucket for a page-batch length (min 1)."""
    b = 1
    while b < n:
        b *= 2
    return b


class MeshTierDomain:
    """A scale-up domain: one serving device plus donor peers, shared by every plane's ``AquaTensor`` of a serving runtime. It
    owns the donor name -> device mapping (stable across evict/re-lease
    cycles), the staging buffers, the leg counter and the measured-leg
    samples."""

    def __init__(self, devices: Optional[Sequence] = None):
        """Build the domain over ``devices`` (default: every CUDA device).

        Raises:
            ValueError: fewer than 2 devices (no peer to donate memory).
        """
        if devices is None:
            devices = [torch.device(f"cuda:{i}")
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if len(devices) < 2:
            raise ValueError(f"mesh tiers need >= 2 devices (got "
                             f"{len(devices)}): a donor lease is a slab of a "
                             "PEER device's memory")
        self.devices = devices
        self.n_dev = len(devices)
        self._donor_dev: Dict[str, int] = {}
        # an optional core/faults.FaultInjector shared with the domain's
        # AquaTensors: a leg addressed to a lost donor is never sent
        self.faults = None
        # one per leg put on the wire (one per (plane, tier, donor) leg)
        self.collectives = 0
        # measured (message_bytes, seconds) per warm fabric leg
        self.samples: Dict[str, List[Tuple[float, float]]] = {"fabric": []}
        self._stage_cache: Dict[tuple, torch.Tensor] = {}
        self._warm: set = set()

    # ------------------------------------------------------------------
    @staticmethod
    def available(min_devices: int = 2) -> bool:
        """True when a default domain can be built here: at least
        ``min_devices`` CUDA devices."""
        return torch.cuda.device_count() >= min_devices

    def attach_faults(self, faults) -> None:
        """Share a ``FaultInjector`` with the domain (lease-boundary checks
        on every leg; the AquaTensors consult the same injector for
        transient-leg retries BEFORE reaching these entry points)."""
        self.faults = faults

    def _guard_donor(self, donor: str, op: str) -> None:
        if self.faults is not None and self.faults.donor_lost(donor):
            raise LeaseRevokedError(
                f"mesh {op} addressed lost donor {donor} — its device left "
                "the domain", donor=donor)

    def donor_device(self, donor: str) -> int:
        """Mesh index of the device backing ``donor``'s leases: assigned on
        first use, cycling over the peers (entry 0 serves), and STABLE for
        the donor's lifetime."""
        if donor not in self._donor_dev:
            self._donor_dev[donor] = (1 + len(self._donor_dev)
                                      % (self.n_dev - 1))
        return self._donor_dev[donor]

    # ------------------------------------------------------------------
    # pool + transfer legs (called by AquaTensor's remote helpers)
    # ------------------------------------------------------------------
    def alloc_pool(self, donor: str, slots: int, page_shape: Tuple[int, ...],
                   dtype: torch.dtype) -> torch.Tensor:
        """A donor lease as a REAL slab: a zeroed ``(slots + 1, *page)``
        tensor on the donor's device. Slot ``slots`` is the scatter scratch
        row that bucket padding targets."""
        self._guard_donor(donor, "lease")
        dst = self.donor_device(donor)    # pin the mapping at lease time
        return torch.zeros((slots + 1,) + tuple(page_shape), dtype=dtype,
                           device=self.devices[dst])

    def push(self, pool: torch.Tensor, donor: str, slots,
             data: torch.Tensor) -> torch.Tensor:
        """Offload leg: move ``data`` (a coalesced page batch on the
        serving device) into ``pool`` (the donor's slab) at ``slots`` —
        ONE copy to the donor, then a scatter there. Returns ``pool``,
        updated in place."""
        self._guard_donor(donor, "push")
        dst = self.donor_device(donor)
        n = len(slots)
        S = pool.shape[0] - 1
        page_shape = tuple(pool.shape[1:])
        b = _bucket(n)
        slots = np.asarray(slots, np.int32)
        data = data.to(self.devices[0], pool.dtype)
        if b > n:                         # pad to the bucket: scratch row
            slots = np.concatenate([slots, np.full(b - n, S, np.int32)])
            data = torch.cat([data, data.new_zeros((b - n,) + page_shape)])
        key = ("push", dst, b, S, page_shape, str(pool.dtype))
        stage = self._stage(key, pool.device, (b,) + page_shape, pool.dtype)
        ids = torch.from_numpy(slots).to(pool.device)
        dt = self._timed(lambda: kv_ops.scatter_pages(
            pool, stage.copy_(data), ids))
        self._account(key, b * int(np.prod(page_shape)) * pool.element_size(),
                      dt)
        return pool

    def pull(self, pool: torch.Tensor, donor: str, slots) -> torch.Tensor:
        """Restore leg: gather ``slots`` from the donor's slab and move
        them to the serving device — ONE copy. Returns the ``(n, *page)``
        staging batch on the serving device."""
        self._guard_donor(donor, "pull")
        src = self.donor_device(donor)
        n = len(slots)
        S = pool.shape[0] - 1
        page_shape = tuple(pool.shape[1:])
        b = _bucket(n)
        slots = np.asarray(slots, np.int32)
        if b > n:                         # padded gathers are discarded
            slots = np.concatenate([slots, np.zeros(b - n, np.int32)])
        key = ("pull", src, b, S, page_shape, str(pool.dtype))
        ids = torch.from_numpy(slots).to(pool.device)
        out = torch.empty((b,) + page_shape, dtype=pool.dtype,
                          device=self.devices[0])
        dt = self._timed(lambda: out.copy_(kv_ops.gather_pages(pool, ids)))
        self._account(key, b * int(np.prod(page_shape)) * pool.element_size(),
                      dt)
        return out[:n]

    # ------------------------------------------------------------------
    @staticmethod
    def _timed(fn) -> float:
        """Wall seconds of one leg, from its dispatch until its output
        tensor is ready. The output's device orders the whole leg on its
        current stream (a copy across devices makes the destination's
        stream wait for it), so one event there marks the leg's end."""
        t0 = time.perf_counter()
        out = fn()
        if out.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
            done.synchronize()
        return time.perf_counter() - t0

    def _account(self, key: tuple, nbytes: int, dt: float):
        self.collectives += 1
        if key in self._warm:             # the first call of a key: unsampled
            self.samples["fabric"].append((float(nbytes), float(dt)))
        else:
            self._warm.add(key)

    def _stage(self, key: tuple, device: torch.device, shape: tuple,
               dtype: torch.dtype) -> torch.Tensor:
        """The push's staging buffer on the donor, one per key."""
        buf = self._stage_cache.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, device=device)
            self._stage_cache[key] = buf
        return buf

    # ------------------------------------------------------------------
    def calibrated_profile(self, hw, *, min_samples: int = 4):
        """A copy of ``hw`` whose fabric link is least-squares fitted to the
        measured push/pull samples (``perfmodel.calibrate_profile``); ``hw``
        itself when there are not yet enough samples to fit."""
        from repro_torch.core.perfmodel import calibrate_profile
        return calibrate_profile(hw, fabric_samples=self.samples["fabric"],
                                 min_samples=min_samples)
