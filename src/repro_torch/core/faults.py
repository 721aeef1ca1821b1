"""Fault injection + invariant auditing for the tiered serving runtime —
the reference's ``repro/core/faults.py`` kept as the port's own copy
(numpy only).

Donors are MORTAL. Production scale-up domains lose transfer legs
transiently (a congested fabric hop), lose donors permanently (the
peer's process dies), and — the ROADMAP's named gap — have donors shrink
their leases dynamically when their OWN serving load needs the HBM back.
Every one of those must be a priced, recoverable event rather than an
undefined state.

Two pieces:

``FaultInjector``
    A deterministic, seedable oracle the data plane consults at every
    transfer leg and lease boundary. Three fault classes:

      * transient leg failures — Bernoulli per (tier, donor) leg at
        ``leg_fault_rate``, with a per-leg consecutive-failure streak capped
        at ``max_consecutive`` (the cap forces the next attempt to succeed),
        so bounded retry-with-backoff provably converges below
        ``max_leg_retries`` and the recovery path stays deterministic for a
        given seed;
      * permanent donor loss — scheduled ``donor_loss`` events; once a donor
        is marked lost every leg addressing it raises
        :class:`~repro_torch.core.errors.LeaseRevokedError` and its resident pages
        become the LOST tier (:class:`~repro_torch.core.errors.PageLossError` on
        touch);
      * dynamic lease shrinkage — scheduled ``lease_shrink`` events: the
        donor reclaims a fraction of its slots and the runtime live-migrates
        the occupants to other donors or the HOST tier.

    Scheduled events carry EITHER an engine-step trigger (``at_step``) or an
    analytic-clock trigger (``at_time``) so the same schedule drives the
    real engine and the discrete-event simulator.

    Failed attempts are decided BEFORE a leg is issued, so a failed attempt
    never moves a byte; retries are priced (full message time + exponential backoff,
    ``TransferMeter.record_retry``) and counted in the meter's
    ``retries_fabric`` / ``retries_host`` — never in ``messages_*``.

``InvariantAuditor``
    One consistency oracle for every recovery path: refcounts vs block
    tables, free lists vs physical tier occupancy, LOCAL pins vs active
    referencers, the prefix index vs live pages, and (given the engine)
    batch-slot bookkeeping. Runs after every
    engine step under ``ServingEngine(audit=True)`` and inside the chaos
    tests; any inconsistency raises
    :class:`~repro_torch.core.errors.InvariantViolation` listing every failed
    check at once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.errors import InvariantViolation


@dataclass
class FaultEvent:
    """One scheduled control-plane fault.

    kind: ``"donor_loss"`` (the peer dies holding its slab),
    ``"lease_shrink"`` (the donor reclaims ``frac`` of its slots),
    ``"cancel"`` (the client abandons request ``rid`` — engine/simulator
    tear it out of whatever lifecycle state it is in and reclaim its
    pages), or ``"engine_crash"`` (the serving process dies: the engine
    raises :class:`~repro_torch.core.errors.EngineCrashError` and the harness
    recovers via ``ServingEngine.restore`` from the latest snapshot).
    Exactly one of ``at_step`` (engine-step clock) / ``at_time`` (analytic
    seconds) should be set; the matching clock's poll fires it once.
    """
    kind: str
    donor: str = ""
    frac: float = 1.0
    rid: Optional[int] = None
    at_step: Optional[int] = None
    at_time: Optional[float] = None
    fired: bool = field(default=False, compare=False)


class FaultInjector:
    """Deterministic, seedable fault oracle for transfer legs and leases.

    Args:
        seed: RNG seed — the whole fault trace is a pure function of it.
        leg_fault_rate: Bernoulli probability a transfer-leg attempt fails.
        max_consecutive: cap on consecutive failures of one (tier, donor)
            leg; once reached the next attempt is FORCED to succeed. Keep it
            below ``max_leg_retries`` and bounded retry always converges.
        max_leg_retries: retry budget per leg before the runtime gives up
            with ``TransferFaultError`` (only reachable when transient
            faults are configured unbounded, e.g. ``max_consecutive=0``
            semantics are not supported — the floor is 1).
        events: scheduled :class:`FaultEvent` list (donor loss / shrink).
    """

    def __init__(self, *, seed: int = 0, leg_fault_rate: float = 0.0,
                 max_consecutive: int = 2, max_leg_retries: int = 6,
                 events: Sequence[FaultEvent] = ()):
        if not 0.0 <= leg_fault_rate <= 1.0:
            raise ValueError(f"leg_fault_rate={leg_fault_rate} not in [0, 1]")
        if max_consecutive < 1:
            raise ValueError("max_consecutive must be >= 1 (a leg that can "
                             "never succeed is donor loss, not a transient)")
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.leg_fault_rate = float(leg_fault_rate)
        self.max_consecutive = int(max_consecutive)
        self.max_leg_retries = int(max_leg_retries)
        self.events: List[FaultEvent] = list(events)
        self._streak: Dict[Tuple[int, Optional[str]], int] = {}
        self._lost: Set[str] = set()
        # observability: everything injected, for tests and benchmarks
        self.leg_faults_injected = 0
        self.events_fired: List[FaultEvent] = []

    # -- transient leg faults ---------------------------------------------
    def leg_fails(self, tier, donor: Optional[str] = None) -> bool:
        """One Bernoulli draw for a transfer-leg attempt on (tier, donor).

        ``tier`` is any hashable leg key — the runtime passes its int tier
        constants, the analytic simulator its tier name strings.

        A leg whose consecutive-failure streak reached ``max_consecutive``
        is forced to succeed (streak resets) — the determinism contract that
        keeps bounded retry convergent for any seed."""
        if self.leg_fault_rate <= 0.0:
            return False
        key = (tier, donor)
        if self._streak.get(key, 0) >= self.max_consecutive:
            self._streak[key] = 0
            return False
        if self.rng.random() < self.leg_fault_rate:
            self._streak[key] = self._streak.get(key, 0) + 1
            self.leg_faults_injected += 1
            return True
        self._streak[key] = 0
        return False

    # -- permanent donor loss ---------------------------------------------
    def mark_donor_lost(self, donor: str):
        """Record a donor as permanently gone: every later leg or lease
        operation addressing it must raise ``LeaseRevokedError``."""
        self._lost.add(donor)

    def donor_lost(self, donor: Optional[str]) -> bool:
        return donor is not None and donor in self._lost

    @property
    def lost_donors(self) -> Set[str]:
        return set(self._lost)

    # -- scheduled events ---------------------------------------------------
    def due_events(self, *, step: Optional[int] = None,
                   now: Optional[float] = None) -> List[FaultEvent]:
        """Pop every not-yet-fired event due on the calling clock.

        Engine callers pass ``step`` (fires ``at_step`` events); simulator
        callers pass ``now`` in analytic seconds (fires ``at_time`` events).
        Each event fires exactly once, in schedule order."""
        due = []
        for ev in self.events:
            if ev.fired:
                continue
            if ev.at_step is not None and step is not None \
                    and step >= ev.at_step:
                due.append(ev)
            elif ev.at_time is not None and now is not None \
                    and now >= ev.at_time:
                due.append(ev)
        for ev in due:
            ev.fired = True
            self.events_fired.append(ev)
        return due


class InvariantAuditor:
    """Consistency oracle over the paged runtime (+ optionally the engine).

    ``check`` returns a list of human-readable violations (empty = clean);
    ``audit`` raises :class:`InvariantViolation` carrying all of them. The
    mesh leg check is STATEFUL (deltas since the previous audit of the same
    runtime), so construct one auditor per engine/test.
    """

    def __init__(self):
        self._last_collectives: Optional[int] = None
        self._last_messages: Optional[float] = None
        self.audits = 0

    # ------------------------------------------------------------------
    def audit(self, runtime, *, engine=None) -> None:
        bad = self.check(runtime, engine=engine)
        if bad:
            raise InvariantViolation(bad)

    def check(self, runtime, *, engine=None) -> List[str]:
        """Audit a :class:`~repro_torch.serving.kv_cache.PagedStateRuntime`.

        Checks, per plane:
          1. free lists and page-table occupancy PARTITION every tier's
             physical slots (no slot leaked, none double-booked);
          2. every page's refcount equals the number of block tables
             referencing it (+1 for the plane's scratch page), and every
             refcount-0-but-resident page is a legal CACHED page: caching
             enabled, indexed in exactly one radix block, never pinned,
             never LOST;
          3. LOCAL pin counts equal the number of ACTIVE referencers, and
             every pinned page is LOCAL;
          4. no block table references a LOST-tier page (recovery must
             re-queue every victim before the audit);
          5. the radix tree is well-formed (children keyed by their first
             block, page-aligned edges, parent links intact), every node
             page is allocated, each page appears in exactly one block,
             and the reverse map agrees in both directions.
        Runtime-wide: mesh legs vs priced fabric messages move in lockstep
        (every priced message is backed by >= 1 leg on the wire; retries
        are priced but never put one there). With ``engine``: batch slots
        partition and the scheduler budget does not exceed what the tiers
        can physically hold.
        """
        from repro_torch.core.aqua_tensor import (HOST, LOCAL, LOST, REMOTE,
                                                  TIER_NAMES)
        self.audits += 1
        bad: List[str] = []
        for name, plane in runtime.planes.items():
            aq = plane.aqua
            pt = aq.page_table
            # -- 1. free-list / occupancy partition per tier --------------
            def _partition(tier, used_slots, free_list, capacity, label):
                used = [int(s) for s in used_slots]
                if len(set(free_list)) != len(free_list):
                    bad.append(f"{name}/{label}: duplicate free slots")
                overlap = set(free_list) & set(used)
                if overlap:
                    bad.append(f"{name}/{label}: slots {sorted(overlap)} "
                               "both free and occupied")
                if len(used) != len(set(used)):
                    bad.append(f"{name}/{label}: double-booked slots")
                covered = set(free_list) | set(used)
                expect = set(range(capacity))
                if covered != expect:
                    missing = sorted(expect - covered)[:8]
                    extra = sorted(covered - expect)[:8]
                    bad.append(f"{name}/{label}: slot partition broken "
                               f"(missing {missing}, out-of-range {extra})")

            _partition(LOCAL, pt[pt[:, 0] == LOCAL, 1], aq._free_local,
                       aq.local_pool.shape[0], "local")
            _partition(HOST, pt[pt[:, 0] == HOST, 1], aq._free_host,
                       aq.host_pool.shape[0], "host")
            for donor, free in aq._remote_free.items():
                di = aq._donors.index(donor)
                used = pt[(pt[:, 0] == REMOTE) & (pt[:, 2] == di), 1]
                _partition(REMOTE, used, free,
                           aq.remote_capacity.get(donor, 0), f"remote:{donor}")
            # a donor with pages but no pool (and not marked LOST) leaked
            for di_val in np.unique(pt[pt[:, 0] == REMOTE, 2]):
                donor = aq._donors[int(di_val)]
                if donor not in aq.remote_pools:
                    bad.append(f"{name}: pages on donor {donor} but its "
                               "lease is gone")

            # -- 2 + 3. refcounts and pins vs block tables ----------------
            refs: Dict[int, int] = {}
            active_refs: Dict[int, int] = {}
            for rid, rows in plane.pages.items():
                seen = set()
                for row in rows:
                    for lp in row:
                        lp = int(lp)
                        if lp in seen:
                            continue      # one ref per (request, page)
                        seen.add(lp)
                        refs[lp] = refs.get(lp, 0) + 1
                        if rid in runtime._active:
                            active_refs[lp] = active_refs.get(lp, 0) + 1
            refs[plane.scratch_lp] = refs.get(plane.scratch_lp, 0) + 1
            allocated = set(np.nonzero(pt[:, 0] != -1)[0].tolist())
            for lp in sorted(set(refs) | allocated):
                want = refs.get(lp, 0)
                have = int(aq.page_refs[lp])
                if pt[lp, 0] == -1:
                    bad.append(f"{name}: page {lp} referenced but "
                               "unallocated")
                elif want != have:
                    bad.append(f"{name}: page {lp} refcount {have} != "
                               f"{want} block-table referencer(s)")
                elif want == 0:
                    # resident with no referencer: legal only as a CACHED
                    # page owned by the radix index
                    if not getattr(runtime, "caching", False):
                        bad.append(f"{name}: page {lp} resident at "
                                   "refcount 0 but caching is off (leak)")
                    elif (name, lp) not in runtime._lp_node:
                        bad.append(f"{name}: cached page {lp} not in the "
                                   "radix index (leak)")
                    if plane.pin.get(lp, 0):
                        bad.append(f"{name}: cached page {lp} is pinned")
                    if pt[lp, 0] == LOST:
                        bad.append(f"{name}: cached page {lp} sits in the "
                                   "LOST tier (donor death must drop it)")
            for lp, c in plane.pin.items():
                want = active_refs.get(int(lp), 0)
                if c != want:
                    bad.append(f"{name}: page {lp} pin {c} != {want} "
                               "active referencer(s)")
                if pt[lp, 0] != LOCAL:
                    bad.append(f"{name}: pinned page {lp} is "
                               f"{TIER_NAMES.get(int(pt[lp, 0]), '?')}, "
                               "not local")
            for lp, c in active_refs.items():
                if c > 0 and plane.pin.get(lp, 0) != c:
                    bad.append(f"{name}: page {lp} active refs {c} but pin "
                               f"{plane.pin.get(lp, 0)}")

            # -- 4. lost pages must have been recovered away --------------
            lost_ref = [lp for lp in refs
                        if lp != plane.scratch_lp and pt[lp, 0] == LOST]
            if lost_ref:
                bad.append(f"{name}: block tables still reference LOST "
                           f"pages {sorted(lost_ref)[:8]}")

        # -- 5. radix tree <-> reverse map <-> live pages ------------------
        seen_pages: Dict = {}
        for seed, root in runtime._roots.items():
            stack = list(root.children.items())
            while stack:
                key, node = stack.pop()
                if not node.blocks or node.blocks[0] != key:
                    bad.append(f"radix child of seed {seed!r} keyed by a "
                               "block that is not its first block")
                if len(node.blocks) != len(node.pages):
                    bad.append(f"radix node has {len(node.blocks)} blocks "
                               f"but {len(node.pages)} page sets")
                for bt in node.blocks:
                    if len(bt) != runtime.page_tokens:
                        bad.append("radix edge block is not page-aligned "
                                   f"({len(bt)} tokens)")
                for bi, pagedict in enumerate(node.pages):
                    for name, lps in pagedict.items():
                        aq = runtime.planes[name].aqua
                        for lp in lps:
                            lp = int(lp)
                            if aq.page_table[lp, 0] == -1:
                                bad.append(f"radix node points at freed "
                                           f"{name} page {lp}")
                            k = (name, lp)
                            if k in seen_pages:
                                bad.append(f"{name} page {lp} appears in "
                                           "two radix blocks")
                            seen_pages[k] = (node, bi)
                            if runtime._lp_node.get(k) != (node, bi):
                                bad.append("radix reverse map disagrees "
                                           f"for {name} page {lp}")
                for ckey, child in node.children.items():
                    if child.parent is not node:
                        bad.append("radix child parent link broken")
                    stack.append((ckey, child))
        for k in runtime._lp_node:
            if k not in seen_pages:
                bad.append(f"reverse map entry {k} -> unreachable radix "
                           "node")

        # -- mesh legs vs priced fabric messages ---------------------------
        mesh = getattr(runtime, "mesh", None)
        if mesh is not None:
            c, m = mesh.collectives, runtime.meter.messages_fabric
            if self._last_collectives is not None:
                dc = c - self._last_collectives
                dm = m - self._last_messages
                if dm > dc:
                    bad.append(f"meter priced {dm} fabric messages but only "
                               f"{dc} collectives went on the wire (retries must "
                               "never count as messages)")
            self._last_collectives, self._last_messages = c, m

        # -- engine bookkeeping -------------------------------------------
        if engine is not None:
            slots = [r.slot for r in engine.running if r.slot is not None]
            if len(slots) != len(set(slots)):
                bad.append(f"duplicate batch slots {sorted(slots)}")
            if len(slots) != len(engine.running):
                bad.append("running request without a batch slot")
            covered = set(slots) | set(engine._free_slots)
            if covered != set(range(engine.max_running)) \
                    or len(engine._free_slots) != len(set(engine._free_slots)):
                bad.append("batch slots do not partition "
                           f"(used={sorted(slots)}, "
                           f"free={sorted(engine._free_slots)})")
            cap = engine.kv.total_capacity()
            if np.any(np.asarray(engine.sched.page_budget) > cap):
                bad.append(f"scheduler budget {engine.sched.page_budget} "
                           f"exceeds physical tier capacity {cap}")
            # no pin survives its referencer: every ACTIVE (pin-holding)
            # rid must still be a live engine request — a retired/cancelled
            # rid left in _active would hold its pages pinned LOCAL forever
            live = ({r.rid for r in engine.running}
                    | {r.rid for r in engine.waiting})
            orphans = sorted(set(runtime._active) - live)
            if orphans:
                bad.append(f"active (pinned) rids {orphans[:8]} have no "
                           "live request — a pin survived its referencer")
            # prefetched restores must reference live waiting requests only
            stale = sorted(r.rid for r in getattr(engine, "_prefetched", [])
                           if r.rid not in live)
            if stale:
                bad.append(f"prefetched restore(s) for retired rid(s) "
                           f"{stale[:8]} — release must clear prefetch pins")
        return bad
