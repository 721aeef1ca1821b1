"""Typed error hierarchy for the serving runtime.

Every deliberate failure the paged serving stack can raise derives from
:class:`AquaError`, so callers distinguish the three classes of trouble by
TYPE instead of parsing message strings:

  * recoverable data-plane faults (``PageLossError``, ``TransferFaultError``)
    — the engine owns a recovery policy for each (recompute from the prompt,
    bounded retry-with-backoff);
  * control-plane lease faults (``LeaseRevokedError``) — a donor that shrank
    or revoked its lease must never be addressed again;
  * invariant violations (``SchedulingInvariantError``,
    ``InvariantViolation``) — bugs, never recovered from, always loud.

Genuine capacity exhaustion stays ``MemoryError`` (``AquaTensor`` raising
"all tiers full"): it is the contract the page-budget-aware schedulers are
designed around and the signal opportunistic allocations (speculative
chunks, CoW clones) already handle. Bare asserts and untyped raises in
serving hot paths are banned by a CI grep-guard; everything intentional
raises one of these (or a stdlib ``ValueError`` for caller-input mistakes).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


class AquaError(RuntimeError):
    """Base class of every intentional serving-runtime failure."""


class PageLossError(AquaError):
    """Pages became irrecoverable (their donor died holding the only copy).

    Raised when a lost-tier page is read, migrated, or ensured LOCAL. The
    engine's recovery policy: release the victim request's surviving pages,
    re-queue it, and RECOMPUTE its context from the prompt (prefill restarts
    past any still-resident shared prefix) instead of crashing the step.
    """

    def __init__(self, message: str, *, plane: Optional[str] = None,
                 pages: Sequence[int] = ()):
        super().__init__(message)
        self.plane = plane
        self.pages: Tuple[int, ...] = tuple(int(p) for p in pages)


class LeaseRevokedError(AquaError):
    """A transfer leg or lease operation addressed a donor whose lease is
    gone (permanent loss, or revoked by the donor). Unlike a transient leg
    fault this is never retried — the slab no longer exists."""

    def __init__(self, message: str, *, donor: Optional[str] = None):
        super().__init__(message)
        self.donor = donor


class TransferFaultError(AquaError):
    """A transfer leg kept failing past the bounded retry budget. With a
    :class:`~repro.core.faults.FaultInjector` whose transient faults respect
    ``max_consecutive`` this is unreachable; it fires only when a leg is
    configured to fail persistently (``leg_fault_rate=1``) — an operator
    signal, not a recovery path."""

    def __init__(self, message: str, *, tier: Optional[int] = None,
                 donor: Optional[str] = None, attempts: int = 0):
        super().__init__(message)
        self.tier = tier
        self.donor = donor
        self.attempts = attempts


class SchedulingInvariantError(AquaError):
    """The planned run set violated an engine invariant (e.g. more requests
    than free batch slots) — a scheduler bug that must fail loudly instead of
    silently skipping placement and serving the request never."""


class InvariantViolation(AquaError):
    """The :class:`~repro.core.faults.InvariantAuditor` found the runtime
    inconsistent (refcounts vs block tables vs physical occupancy vs
    meter/collective counts). Carries every violation found in one pass."""

    def __init__(self, violations: Sequence[str]):
        self.violations: Tuple[str, ...] = tuple(violations)
        lines = "\n  - ".join(self.violations)
        super().__init__(f"{len(self.violations)} invariant violation(s):"
                         f"\n  - {lines}")


class CancelledError(AquaError):
    """The request was torn down before completion — by a client cancel
    (``ServingEngine.cancel``), a missed deadline (the engine's per-step
    deadline sweep), or a seeded ``"cancel"`` fault event.

    Cancellation is a NORMAL lifecycle outcome, not a fault: the engine's
    recovery policy is the same teardown the finish ladder performs (free
    the batch slot, release every plane page through refcounts, un-pin
    prefetched restores, ``admission.forget``) plus publication of the
    completed prefix pages into the radix cache so the work is not wasted.
    Raised only on the RESULT path (``ServingEngine.output``) when a caller
    asks for the tokens of a cancelled request — never from ``cancel``
    itself, which is idempotent and returns a bool."""

    def __init__(self, message: str, *, rid: Optional[int] = None,
                 reason: Optional[str] = None):
        super().__init__(message)
        self.rid = rid
        self.reason = reason


class EngineCrashError(AquaError):
    """A seeded ``"engine_crash"`` fault event fired: the serving process
    dies mid-stream, losing every page table, the radix cache and all
    in-flight state. The recovery policy is crash-consistent restart —
    discard the crashed engine and rebuild from the latest
    ``ServingEngine.snapshot()`` journal via ``ServingEngine.restore``;
    greedy decode makes the resumed streams bit-identical, and the recovery
    time is the trajectory ``BENCH_lifecycle.json`` tracks."""


class CapacityError(AquaError):
    """A serving unit cannot physically hold the configured workload (e.g.
    the model weights alone exceed device memory) — a sizing mistake caught
    at construction, not a runtime fault."""


class AdmissionError(AquaError):
    """The SLO-aware admission controller was misconfigured (bad headroom,
    budget, or callback wiring) — caught at construction or the first
    ``filter`` call. NEVER raised on the admit/defer path itself: admission
    degrades overload to queueing, it does not reject requests with errors
    (a deferred request simply waits for the stability region to reopen).
    A CI grep-guard pins ``serving/admission.py`` to raising only typed
    :class:`AquaError` subclasses."""
