"""AQUA central coordinator (paper §3), the reference's
``repro/core/coordinator.py`` kept as the port's own copy.

A thread-safe registry of HBM *producers* (chips with spare memory) and
*consumers* (chips running memory-bound inference). The paper exposes this as
REST endpoints on a coordinator process; here the same surface is a
thread-safe object — the methods map 1:1 onto the paper's endpoints:

    /lease            -> offer(producer, bytes)
    /allocate         -> allocate(consumer, bytes)   (returns donor grants)
    /free             -> free(consumer, donor, bytes)
    /reclaim_request  -> request_reclaim(producer)
    /respond          -> pending_reclaims(consumer)  (polled at iteration
                         boundaries by the consumer control loop)
    /reclaim_status   -> reclaim_status(producer)

AQUA-PLACER pre-pairs each consumer with exactly one producer (one-to-one, so
a donor's fabric bandwidth is never shared — paper §4); the coordinator
enforces the pairing but also supports opportunistic many-to-many grants for
clusters run without the placer (flag ``strict_pairing=False``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass
class Offer:
    producer: str
    total_bytes: float
    granted_bytes: float = 0.0
    reclaim_requested: bool = False

    @property
    def available(self) -> float:
        return 0.0 if self.reclaim_requested else self.total_bytes - self.granted_bytes


@dataclass
class Grant:
    consumer: str
    producer: str
    nbytes: float
    released: bool = False


class Coordinator:
    def __init__(self, *, strict_pairing: bool = True):
        self._lock = threading.Lock()
        self._offers: Dict[str, Offer] = {}
        self._grants: List[Grant] = []
        self._pairing: Dict[str, str] = {}      # consumer -> producer
        self.strict_pairing = strict_pairing

    # -- placement ------------------------------------------------------
    def set_pairing(self, pairs: Dict[str, str]):
        """Install AQUA-PLACER's consumer->producer matching."""
        with self._lock:
            self._pairing = dict(pairs)

    # -- producer side ----------------------------------------------------
    def offer(self, producer: str, nbytes: float):
        """Producer leases `nbytes` of its HBM to the pool (/lease)."""
        with self._lock:
            o = self._offers.get(producer)
            if o is None:
                self._offers[producer] = Offer(producer, nbytes)
            else:
                # re-offer replaces the lease size (never below what is granted)
                o.total_bytes = max(nbytes, o.granted_bytes)
                o.reclaim_requested = False

    def request_reclaim(self, producer: str):
        """Producer wants its memory back (/reclaim_request)."""
        with self._lock:
            if producer in self._offers:
                self._offers[producer].reclaim_requested = True

    def reclaim_status(self, producer: str) -> bool:
        """True when every grant against this producer has been released."""
        with self._lock:
            return not any(g.producer == producer and not g.released
                           for g in self._grants)

    def withdraw(self, producer: str):
        with self._lock:
            self._offers.pop(producer, None)

    # -- consumer side ----------------------------------------------------
    def allocate(self, consumer: str, nbytes: float) -> List[Tuple[str, float]]:
        """Request offloaded memory (/allocate). Returns [(donor, bytes)...];
        empty list means fall back to host DRAM (paper §3)."""
        with self._lock:
            grants: List[Tuple[str, float]] = []
            remaining = nbytes
            producers = self._candidate_producers(consumer)
            for p in producers:
                o = self._offers.get(p)
                if o is None or o.available <= 0:
                    continue
                take = min(o.available, remaining)
                o.granted_bytes += take
                self._grants.append(Grant(consumer, p, take))
                grants.append((p, take))
                remaining -= take
                if remaining <= 0:
                    break
            return grants

    def free(self, consumer: str, producer: str, nbytes: float):
        """Consumer released offloaded pages (/free)."""
        with self._lock:
            for g in self._grants:
                if (g.consumer == consumer and g.producer == producer
                        and not g.released and g.nbytes >= nbytes - 1e-9):
                    g.released = True
                    o = self._offers.get(producer)
                    if o is not None:
                        o.granted_bytes -= g.nbytes
                    break

    def pending_reclaims(self, consumer: str) -> List[str]:
        """Donors that asked for their memory back (/respond poll)."""
        with self._lock:
            return sorted({g.producer for g in self._grants
                           if g.consumer == consumer and not g.released
                           and self._offers.get(g.producer) is not None
                           and self._offers[g.producer].reclaim_requested})

    # -- introspection ------------------------------------------------------
    def _candidate_producers(self, consumer: str) -> List[str]:
        if self.strict_pairing and consumer in self._pairing:
            return [self._pairing[consumer]]
        return sorted(self._offers, key=lambda p: -self._offers[p].available)

    def stats(self) -> Dict[str, Dict]:
        with self._lock:
            return {p: {"total": o.total_bytes, "granted": o.granted_bytes,
                        "reclaiming": o.reclaim_requested}
                    for p, o in self._offers.items()}
