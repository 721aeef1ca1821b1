"""The serving engine: chunked continuous batching with FCFS or CFS on the
paged state runtime — the fused-step core of ``repro/serving/engine.py``.

Every step is ONE call of ``api.serve_step_paged``: each decode lane and
each scheduled prompt chunk is packed into a (rows x chunk-bucket) token
batch with per-row ``(q_start, n_real, is_decode)`` metadata, and each layer
serves all rows in one paged attention launch. A CFS preemption is a
page-table tier flip (``PagedStateRuntime.park``/``restore``: one coalesced
message per (tier, donor)). Step times are priced on the analytic clock of
``core/perfmodel.py`` (``EngineMetrics.sim_time``); the engine's real
numerics run on the serving device.

The AQUA lease lifecycle: with a ``coordinator`` the engine leases donor
memory at construction and polls pending reclaims every ``respond_every``
steps (the paper's ``aqua.respond()``), evacuating a reclaimed donor's pages
to HOST at the iteration boundary. A ``faults`` injector's scheduled events
apply at the top of a step: a lease shrink live-migrates the reclaimed
slots' pages, a donor loss flips its pages to LOST and recomputes every
victim request from its prompt; both re-plan the scheduler's page budget.
``audit=True`` runs the invariant auditor after every step.

Admission and the request lifecycle: with ``admission`` an SLO-aware
controller (``serving/admission.py``) gates the waiting queue ahead of the
scheduler, deferring whatever would push the committed set's projected page
occupancy past ``admission_headroom`` x the budget. A request leaves
through one teardown path (``_retire``) whether it finishes, is cancelled
(``cancel``, a ``cancel`` fault event) or misses a deadline
(``deadline_s`` / ``ttft_deadline_s``); ``drain`` parks every in-flight
request to HOST and holds the queue until ``resume``; ``watchdog_steps``
recomputes requests that stopped making progress; ``snapshot`` serializes
the whole serving state to host memory and ``ServingEngine.restore``
rebuilds an engine from it (an ``engine_crash`` fault event raises
``EngineCrashError`` for the harness to restore from its last snapshot).

Not ported yet, and refused by the constructor's signature: the mesh tier
domain (``mesh``) and the ``paged_impl`` switch (the port dispatches its
kernels by the tensors' device); clock calibration is absent.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, fields as dataclass_fields
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.aqua_tensor import HOST, REMOTE
from repro_torch.core.coordinator import Coordinator
from repro_torch.core.device import resolve_device
from repro_torch.core.errors import (CancelledError, EngineCrashError,
                                     SchedulingInvariantError)
from repro_torch.core.faults import InvariantAuditor
from repro_torch.core.perfmodel import (H100_SXM, HardwareProfile, ModelCost,
                                        overlapped_transfer_time)
from repro_torch.models import api
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.kv_cache import PagedStateRuntime
from repro_torch.serving.scheduler import (CFSScheduler, Decision,
                                           FCFSScheduler, ReqState,
                                           bucket_tokens, fairness_spread,
                                           split_step_budget)


@dataclass
class EngineMetrics:
    sim_time: float = 0.0
    steps: int = 0
    prefills: int = 0                     # prefill chunk rows executed
    preemptions: int = 0
    restores: int = 0
    prefetched_restores: int = 0          # restores overlapped with compute
    overlap_hidden_s: float = 0.0         # transfer time hidden by overlap
    spec_chunks: int = 0                  # speculative chunk-ahead grants
    spec_tokens: int = 0
    spec_restores: int = 0                # spec flips ride outside the
    #                                       preemption/restore counters
    ttft: Dict[int, float] = field(default_factory=dict)
    rct: Dict[int, float] = field(default_factory=dict)
    fairness_trace: List[int] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    prefill_tokens_trace: List[int] = field(default_factory=list)
    launch_trace: List[int] = field(default_factory=list)
    baseline_launch_trace: List[int] = field(default_factory=list)
    # fault accounting (zero on a fault-free run): leg retries absorbed by
    # backoff, donor losses and lease shrinks applied, pages migrated off
    # shrinking donors, requests recomputed from the prompt after a loss
    leg_retries: int = 0
    donor_losses: int = 0
    lease_shrinks: int = 0
    migrated_pages: int = 0
    recomputes: int = 0
    recovered_rids: List[int] = field(default_factory=list)
    # bursts and admission: waiting-queue depth at each plan, the running
    # set's occupied fraction of the page budget (max over planes, shared
    # prefixes counted once) and cumulative defer decisions (0 without
    # admission)
    queue_depth_trace: List[int] = field(default_factory=list)
    occupancy_trace: List[float] = field(default_factory=list)
    admission_deferrals: int = 0
    # the request lifecycle: submissions, teardowns before completion
    # (client and fault cancels and deadline expiries), the expiries among
    # them, requests parked by a drain and watchdog recomputes
    submitted: int = 0
    cancelled: int = 0
    deadline_missed: int = 0
    drained: int = 0
    watchdog_trips: int = 0

    def ttft_quantile(self, q: float, *, censored: int = 0) -> float:
        """TTFT quantile on the analytic clock (nan when no request has a
        first token yet). ``censored`` submitted requests that never got a
        first token (cancelled, expired, still queued) count as +inf
        observations, so a quantile in that tail is ``inf``; the engine's
        own count is ``metrics.submitted - len(metrics.ttft)``."""
        xs = sorted(self.ttft.values())
        n = len(xs) + max(int(censored), 0)
        if n == 0:
            return float("nan")
        i = min(int(q * n), n - 1)
        return float(xs[i]) if i < len(xs) else float("inf")


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_running: int = 4,
                 max_seq: int = 128, scheduler: str = "cfs",
                 slice_tokens: int = 4, offload_tier: int = REMOTE,
                 kv: Optional[PagedStateRuntime] = None,
                 kv_page_tokens: int = 8,
                 kv_local_pages: Optional[int] = None,
                 kv_host_pages: int = 8192,
                 prefix_sharing: bool = True,
                 prefix_cache: bool = True,
                 step_tokens: Optional[int] = None,
                 prefetch: bool = True,
                 spec_chunk_ahead: bool = True,
                 coordinator: Optional[Coordinator] = None,
                 name: str = "llm0", hw: HardwareProfile = H100_SXM,
                 want_remote_bytes: float = 0.0, respond_every: int = 4,
                 faults=None, audit: bool = False,
                 admission: bool = False, admission_headroom: float = 0.9,
                 prefill_admit_limit: Optional[int] = 4,
                 slo_ttft_s: Optional[float] = None,
                 watchdog_steps: Optional[int] = None, device=None):
        """Build a serving engine on the paged state runtime.

        Args:
            cfg: model config (paged-servable by the port); ``params`` its
                weights (``lm.LM``) on ``device``.
            max_running: batch slots (concurrent decode lanes).
            max_seq: maximum context length per request.
            scheduler: ``"cfs"`` (fair, preempting) or ``"fcfs"``.
            slice_tokens: CFS fair-pick period in generated tokens.
            offload_tier: preferred park tier (``REMOTE`` / ``HOST``).
            kv: an existing :class:`PagedStateRuntime` (on ``device``); by
                default one is built from the ``kv_*`` sizing knobs and the
                two prefix knobs.
            kv_page_tokens / kv_local_pages / kv_host_pages: the default
                runtime's tokens per page, LOCAL slots per token plane
                (``None``: ``max_running`` full-length requests) and host
                slots per plane.
            prefix_sharing: copy-on-write prompt-prefix sharing (effective
                only on all-token-plane families).
            prefix_cache: retain refcount-0 prefix pages in the radix index
                (effective only with ``prefix_sharing``).
            step_tokens: per-step token budget for chunked prefill
                (``None`` = whole-prompt chunks); must be >= 8.
            prefetch: restore the next plan's parked requests during this
                step (the transfer hidden up to the step's compute time).
            spec_chunk_ahead: hand budget slack to waiting prefills as
                speculative chunks.
            coordinator / want_remote_bytes / respond_every: the AQUA-LIB
                consumer side: lease ``want_remote_bytes`` of donor memory
                at construction, poll reclaims every ``respond_every``
                steps.
            name: engine id in coordinator bookkeeping and errors.
            hw: hardware profile pricing the simulated clock.
            faults: a ``core/faults.FaultInjector``, attached to every
                plane; its scheduled events (lease shrink, donor loss,
                cancel, engine crash) apply at the top of each step.
            audit: run ``InvariantAuditor`` after every step.
            admission: gate the waiting queue with the SLO-aware
                :class:`AdmissionController`: a request enters the
                scheduler's view only while the committed set's projected
                page occupancy (each request growing to its terminal
                context) stays inside ``admission_headroom`` x the page
                budget; the rest waits (never rejected).
            admission_headroom: fraction of the budget the projection may
                fill.
            prefill_admit_limit: with admission, the most requests in their
                prefill phase at once while decode lanes are live (``None``:
                no cap).
            slo_ttft_s: TTFT SLO in analytic seconds; admissions projected
                to miss it are counted (``admission.slo_at_risk``).
            watchdog_steps: recompute any running request whose prefill +
                decode progress has not advanced for this many steps
                (``None``: no watchdog).
            device: serving device; CUDA unless the caller passes another
                (raises when CUDA is requested and absent).

        Raises:
            ValueError: the family is not paged-servable, or
                ``step_tokens < 8``.
            AdmissionError: a bad admission headroom or prefill limit.
        """
        if not api.supports_paged(cfg):
            raise ValueError(f"{cfg.name}: not paged-servable by the port")
        if step_tokens is not None and step_tokens < 8:
            raise ValueError("step_tokens must be >= 8 (one chunk bucket)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_running = max_running
        self.max_seq = max_seq
        self.name = name
        self.hw = hw
        self.cost = ModelCost.from_config(cfg)
        self.weight_bytes = cfg.param_count() * torch.empty(
            (), dtype=cfg.dtype()).element_size()
        self.offload_tier = offload_tier
        self.step_tokens = step_tokens
        self.prefetch = prefetch
        self.spec_chunk_ahead = spec_chunk_ahead

        self.kv = kv or PagedStateRuntime(
            cfg, max_seq=max_seq, page_tokens=kv_page_tokens,
            local_pages=kv_local_pages, host_pages=kv_host_pages,
            max_running=max_running, prefix_sharing=prefix_sharing,
            prefix_cache=prefix_cache, device=self.device)
        if self.kv.device != self.device:
            raise ValueError(f"runtime on {self.kv.device}, engine on "
                             f"{self.device}")
        self.pager = self.kv
        page_cost = (self._page_cost_cfs if scheduler == "cfs"
                     else self._page_cost_fcfs)
        page_budget = self.kv.page_budget
        # chunk block tables pad to the request's max pages plus the write
        # window of the largest chunk bucket: one table shape for all rows
        hi = bucket_tokens(max_seq)
        self._pps_pad = (self.kv.pps
                         + math.ceil(hi / self.kv.page_tokens) + 1)
        self.coord = coordinator
        self.respond_every = respond_every
        self._grants: List[tuple] = []
        if coordinator is not None and want_remote_bytes > 0:
            for donor, nbytes in coordinator.allocate(name, want_remote_bytes):
                self.pager.add_remote_lease(donor, nbytes)
                self._grants.append((donor, nbytes))
        self.slice_tokens = slice_tokens
        self._free_slots = list(range(max_running))[::-1]
        prefix_group = ((lambda r: self.kv.prefix_group_of(r.rid))
                        if self.kv.sharing else None)
        if scheduler == "cfs":
            self.sched = CFSScheduler(max_running, slice_tokens,
                                      page_cost=page_cost,
                                      page_budget=page_budget,
                                      prefix_group=prefix_group)
        elif scheduler == "fcfs":
            self.sched = FCFSScheduler(max_running, page_cost=page_cost,
                                       page_budget=page_budget)
        else:
            raise ValueError(f"scheduler must be 'cfs' or 'fcfs', got "
                             f"{scheduler!r}")
        self.waiting: List[ReqState] = []
        self.running: List[ReqState] = []
        self.finished: List[ReqState] = []
        self._prefetched: List[ReqState] = []
        self.metrics = EngineMetrics()
        self._next_rid = 0
        self.watchdog_steps = watchdog_steps
        self._draining = False
        self._watch: Dict[int, tuple] = {}
        # the knobs a snapshot carries so `restore` rebuilds an equally
        # sized engine; LOCAL pages size token planes only (state planes
        # derive from max_running), so read them off a token plane
        tok_plane = next((p for p in self.kv.planes.values()
                          if p.kind == "tokens"), None)
        first_plane = next(iter(self.kv.planes.values()))
        self._snap_knobs = dict(
            max_running=max_running, max_seq=max_seq, scheduler=scheduler,
            slice_tokens=slice_tokens, offload_tier=offload_tier,
            kv_page_tokens=self.kv.page_tokens,
            kv_local_pages=(int(tok_plane.aqua.local_pool.shape[0])
                            if tok_plane is not None else None),
            kv_host_pages=int(first_plane.aqua.host_pool.shape[0]),
            prefix_sharing=self.kv.sharing, prefix_cache=self.kv.caching,
            step_tokens=step_tokens, prefetch=prefetch,
            spec_chunk_ahead=spec_chunk_ahead, name=name,
            admission=admission, admission_headroom=admission_headroom,
            prefill_admit_limit=prefill_admit_limit, slo_ttft_s=slo_ttft_s,
            watchdog_steps=watchdog_steps)
        self.faults = faults
        if faults is not None:
            self.kv.attach_faults(faults)
        self.auditor = InvariantAuditor() if audit else None
        # admission gates the queue ahead of the scheduler; its budget is
        # read through the scheduler, so _replan_capacity contracts it
        self.admission = None
        self._eligible_rids: Optional[set] = None
        if admission:
            self.admission = AdmissionController(
                budget=lambda: np.asarray(self.sched.page_budget,
                                          np.float64),
                current_cost=self._page_cost_now,
                terminal_cost=self._page_cost_fcfs,
                remaining_tokens=lambda r: (
                    r.prompt_positions - r.prefill_pos,
                    r.max_new_tokens - len(r.generated)),
                headroom=admission_headroom,
                step_tokens=self.step_tokens,
                prefill_admit_limit=prefill_admit_limit,
                slo_ttft_s=slo_ttft_s,
                step_time=lambda: self.cost.decode_step_time(
                    self.hw, max(len(self.running), 1), self.max_seq / 2,
                    self.weight_bytes),
                # earliest deadline first; requests without one keep their
                # arrival order after every request that has one
                order_key=lambda r: (
                    (r.arrival + r.deadline_s) if r.deadline_s is not None
                    else float("inf"), r.arrival, r.rid),
                # remaining end-to-end slack: a candidate projected to miss
                # it is kept out of the occupancy trajectory
                deadline_of=lambda r: (
                    None if r.deadline_s is None
                    else r.deadline_s - (self.metrics.sim_time - r.arrival)))

    def _shared_discount(self, r: ReqState,
                         chosen: Sequence[ReqState]) -> np.ndarray:
        """Physical pages this request aliases with the run set chosen so
        far, minus the headroom a pending copy-on-write may claim back."""
        if not self.kv.sharing or not chosen:
            return np.zeros(len(self.kv.planes), np.int64)
        disc = self.kv.shared_pages_with(
            r.rid, [o.rid for o in chosen if o.rid != r.rid])
        if r.shared_tokens and r.prefill_pos < r.shared_tokens:
            disc = np.maximum(disc - self.kv.cow_reserve(), 0)
        return disc

    def _page_cost_cfs(self, r: ReqState,
                       chosen: Sequence[ReqState] = ()) -> np.ndarray:
        """Pages needed LOCAL through the next slice boundary."""
        base = self.kv.pages_per_request(
            min(r.ctx_len + self.slice_tokens, self.max_seq))
        return base - self._shared_discount(r, chosen)

    def _page_cost_now(self, r: ReqState,
                       chosen: Sequence[ReqState] = ()) -> np.ndarray:
        """Pages the request occupies now (no growth), marginal against
        ``chosen``: the admission trajectory's start and the occupancy
        metric."""
        base = self.kv.pages_per_request(min(r.ctx_len, self.max_seq))
        return base - self._shared_discount(r, chosen)

    def _occupancy_frac(self) -> float:
        """Occupied fraction of the per-plane page budget by the running
        set (max over planes, shared prefixes counted once)."""
        budget = np.maximum(np.asarray(self.sched.page_budget, np.float64),
                            1.0)
        pages = np.zeros(len(self.kv.planes), np.float64)
        chosen: List[ReqState] = []
        for r in self.running:
            pages = pages + self._page_cost_now(r, chosen)
            chosen.append(r)
        return float(np.max(pages / budget))

    def _page_cost_fcfs(self, r: ReqState,
                        chosen: Sequence[ReqState] = ()) -> np.ndarray:
        """FCFS never preempts: budget the full remaining generation."""
        remaining = r.max_new_tokens - len(r.generated)
        base = self.kv.pages_per_request(
            min(r.ctx_len + max(remaining, 0), self.max_seq))
        return base - self._shared_discount(r, chosen)

    # ------------------------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: int,
               arrival: float = 0.0, lora_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None) -> ReqState:
        """Queue a request for generation; with prefix sharing on, its
        longest page-aligned prompt prefix already on pages is adopted and
        prefill starts past it (at least the last position is recomputed).

        Args:
            prompt_tokens: prompt token ids.
            max_new_tokens: tokens to generate before the request retires.
            arrival: arrival time on the simulated clock.
            lora_id: prefix-index partition key.
            deadline_s: end-to-end deadline in simulated seconds after
                ``arrival``; past it the step's deadline sweep cancels the
                request (terminal state ``"expired"``) and reclaims its
                pages. With admission, candidates are also priced earliest
                deadline first and a projected miss is deferred.
            ttft_deadline_s: first-token deadline on the same base, binding
                only until the first token lands.

        Returns:
            The queued :class:`ReqState`.
        """
        r = ReqState(self._next_rid, arrival, list(map(int, prompt_tokens)),
                     max_new_tokens, lora_id=lora_id, deadline_s=deadline_s,
                     ttft_deadline_s=ttft_deadline_s)
        self._next_rid += 1
        self.metrics.submitted += 1
        if self.kv.sharing:
            shared = self.kv.adopt_prefix(r.rid, r.prompt_tokens,
                                          seed=lora_id)
            if shared:
                r.shared_tokens = shared
                r.prefill_pos = min(shared, r.prompt_positions - 1)
        self.waiting.append(r)
        return r

    # ------------------------------------------------------------------
    def _respond(self):
        """The paper's ``aqua.respond()``: honour donor reclaims at an
        iteration boundary (evacuate the donor's pages to HOST, release its
        grants), then re-plan the page budget."""
        reclaimed = False
        for donor in self.coord.pending_reclaims(self.name):
            self.pager.evict_remote(donor)
            reclaimed = True
            for d, nbytes in list(self._grants):
                if d == donor:
                    self.coord.free(self.name, donor, nbytes)
                    self._grants.remove((d, nbytes))
        if reclaimed:
            self._replan_capacity()

    # ------------------------------------------------------------------
    # lifecycle transition helpers: the only places where batch slots, page
    # ownership and the finished list change. Every exit (finish, cancel,
    # deadline expiry, lost-page recovery, preemption, drain) goes through
    # them; tests/test_torch_imports.py pins each mutation to one line.
    # ------------------------------------------------------------------
    def _free_slot(self, r: ReqState) -> None:
        """Return a request's batch slot to the pool (no-op if slotless)."""
        if r.slot is not None:
            self._free_slots.append(r.slot)
            r.slot = None

    def _release_pages(self, r: ReqState) -> None:
        """Release every page the request holds; a same-step prefetched
        restore of it must not re-park it at the next ``_place``."""
        self._prefetched = [p for p in self._prefetched if p.rid != r.rid]
        self.kv.release(r.rid)

    def _retire(self, r: ReqState, terminal: str,
                reason: Optional[str] = None) -> None:
        """The one exit: free the slot, release the pages, stamp the
        terminal state (``finished`` / ``cancelled`` / ``expired``) and move
        the request to ``finished``. The caller removes it from
        ``running``/``waiting`` first."""
        self._free_slot(r)
        self._release_pages(r)
        r.parked = None
        r.terminal = terminal
        r.cancel_reason = reason
        r.finish_step = self.metrics.steps
        self.finished.append(r)
        self._watch.pop(r.rid, None)
        if self.admission is not None:
            self.admission.forget(r.rid)

    # ------------------------------------------------------------------
    # cancellation, deadlines, drain, watchdog
    # ------------------------------------------------------------------
    def cancel(self, rid: int, *, reason: str = "client") -> bool:
        """Tear a request out of any state (waiting, prefilling, decoding,
        parked, prefetched or speculated) and reclaim everything it holds,
        within the current step, through the finish path's teardown. Its
        completed page-aligned prompt prefix is first published to the
        radix index, so with the prefix cache on the prefill work done is
        kept for later sharers.

        ``reason`` is recorded on the request (``"client"``, ``"deadline"``,
        ``"fault"``); ``"deadline"`` stamps the ``"expired"`` terminal
        state. Returns False (a no-op) when ``rid`` is unknown or already
        retired, True when the request was torn down."""
        r = next((x for x in self.running + self.waiting if x.rid == rid),
                 None)
        if r is None:
            return False
        if self.kv.sharing:
            self.kv.register_prefix(r.rid, r.prefill_pos)
        if r in self.running:
            self.running.remove(r)
        else:
            self.waiting.remove(r)
        self._retire(r, "expired" if reason == "deadline" else "cancelled",
                     reason=reason)
        self.metrics.cancelled += 1
        return True

    def output(self, rid: int) -> List[int]:
        """Generated tokens of a retired request.

        Raises:
            CancelledError: the request was cancelled or expired.
            ValueError: ``rid`` is unknown or still in flight.
        """
        r = next((x for x in self.finished if x.rid == rid), None)
        if r is None:
            raise ValueError(f"request {rid} is unknown or still in flight")
        if r.terminal in ("cancelled", "expired"):
            raise CancelledError(
                f"request {rid} was {r.terminal} "
                f"({r.cancel_reason or 'no reason recorded'})",
                rid=rid, reason=r.cancel_reason)
        return list(r.generated)

    def _shed_expired(self) -> None:
        """Enforce both deadline clocks at the top of the step, before the
        admission gate sees the queue. A TTFT deadline binds only until the
        first token lands."""
        m = self.metrics
        for r in list(self.waiting) + list(self.running):
            age = m.sim_time - r.arrival
            ttft_miss = (r.ttft_deadline_s is not None
                         and r.rid not in m.ttft
                         and age > r.ttft_deadline_s)
            e2e_miss = r.deadline_s is not None and age > r.deadline_s
            if (ttft_miss or e2e_miss) \
                    and self.cancel(r.rid, reason="deadline"):
                m.deadline_missed += 1

    def _watchdog(self) -> None:
        """Recompute (:meth:`_recover_lost`: release, requeue, prefill
        again) every running request whose prefill + decode progress has
        not moved for ``watchdog_steps`` steps, so the slot it holds comes
        back."""
        m = self.metrics
        for r in list(self.running):
            prog = r.prefill_pos + len(r.generated)
            last, since = self._watch.get(r.rid, (None, m.steps))
            if prog != last:
                self._watch[r.rid] = (prog, m.steps)
            elif m.steps - since >= self.watchdog_steps:
                m.watchdog_trips += 1
                self._watch.pop(r.rid, None)
                self._recover_lost(r.rid)

    def drain(self) -> int:
        """Graceful drain: stop admitting and park every in-flight request
        to HOST, returning once no batch slot is held, no page is pinned
        LOCAL and no prefetch is in flight. Queued requests stay queued;
        parked ones resume where they were after :meth:`resume`. While
        draining, ``step`` admits, speculates and prefetches nothing.
        Returns the number of requests parked (also added to
        ``metrics.drained``)."""
        self._draining = True
        n = 0
        for r in list(self.running):
            self.kv.park(r.rid, r.resident_tokens, prefer=HOST)
            r.parked = True
            self._free_slot(r)
            self.running.remove(r)
            self.waiting.append(r)
            n += 1
        self._prefetched = []
        for r in self.waiting:
            # a prefetched restore left its pages active
            if r.rid in self.kv._active:
                self.kv.park(r.rid, r.resident_tokens, prefer=HOST)
                r.parked = True
                n += 1
        self.metrics.drained += n
        return n

    def resume(self) -> None:
        """Reopen admission after :meth:`drain`; the next plan restores the
        parked set through the normal placement path."""
        self._draining = False

    # ------------------------------------------------------------------
    # fault application and recovery
    # ------------------------------------------------------------------
    def _replan_capacity(self):
        """Cap the scheduler's budget by what the tiers can still hold: the
        run set must fit LOCAL, and after a shrink or loss the tiers behind
        preemption may hold fewer pages than LOCAL itself."""
        self.sched.update_budget(
            np.minimum(self.kv.page_budget, self.kv.total_capacity()))

    def _recover_lost(self, rid: int):
        """A request whose pages died with a donor: release what survives,
        reset it to the start of prefill (past a still-resident shared
        prefix) and re-queue it; greedy decoding regenerates its tokens."""
        m = self.metrics
        r = next((x for x in self.running + self.waiting if x.rid == rid),
                 None)
        if r is None or r.done:
            return
        self._free_slot(r)
        if r in self.running:
            self.running.remove(r)
        self._release_pages(r)
        r.parked = None
        r.prefill_pos = 0
        r.generated = []
        r.shared_tokens = 0
        if self.kv.sharing:
            shared = self.kv.adopt_prefix(r.rid, r.prompt_tokens,
                                          seed=r.lora_id)
            if shared:
                r.shared_tokens = shared
                r.prefill_pos = min(shared, r.prompt_positions - 1)
        if r not in self.waiting:
            self.waiting.append(r)
        if self.admission is not None:
            # back at prefill position 0 and the region may have shrunk:
            # the request re-prices before it re-enters
            self.admission.forget(rid)
        m.recomputes += 1
        m.recovered_rids.append(rid)

    def _apply_faults(self) -> float:
        """Apply the injector's events due at this step (``at_step`` on the
        step counter, ``at_time`` on the analytic clock): a
        ``lease_shrink`` live-migrates the reclaimed slots' pages, a
        ``donor_loss`` sends every victim through :meth:`_recover_lost`, a
        ``cancel`` tears its request down through :meth:`cancel`; then
        re-plan the budget. Returns the metered transfer time of the
        recovery moves.

        Raises:
            EngineCrashError: an ``engine_crash`` event fired; the harness
                discards this engine and rebuilds it from its latest
                :meth:`snapshot` (:meth:`restore`).
        """
        m = self.metrics
        t_before = self.pager.meter.sim_time
        fired = False
        for ev in self.faults.due_events(step=m.steps, now=m.sim_time):
            if ev.kind == "engine_crash":
                raise EngineCrashError(
                    f"{self.name}: seeded engine_crash fired at step "
                    f"{m.steps}; rebuild from the latest snapshot "
                    "(ServingEngine.restore)")
            if ev.kind == "cancel":
                if ev.rid is not None:
                    self.cancel(int(ev.rid), reason="fault")
                continue
            fired = True
            if ev.kind == "lease_shrink":
                m.lease_shrinks += 1
                m.migrated_pages += self.kv.shrink_lease(ev.donor, ev.frac)
            elif ev.kind == "donor_loss":
                m.donor_losses += 1
                for rid in self.kv.fail_donor(ev.donor):
                    self._recover_lost(rid)
        if fired:
            self._replan_capacity()
        return self.pager.meter.sim_time - t_before

    # ------------------------------------------------------------------
    def step(self):
        """Run ONE engine step: poll coordinator reclaims every
        ``respond_every`` steps, apply due fault events and shed expired
        requests, pass the queue through the admission gate (nothing while
        draining), plan the run set (``sched.plan`` under the page budget),
        park the preempted and slot + restore the scheduled (``_place``),
        run every decode token and every fair-share prompt chunk in one
        fused call (``_fused_step``), retire finished requests, run the
        watchdog and prefetch the next step's restores; with ``audit``,
        audit the runtime. Metrics accrue on ``self.metrics``.

        Raises:
            SchedulingInvariantError: the plan needs more batch slots than
                exist.
            MemoryError: a page allocation or tier flip found its tier full.
            EngineCrashError: a scheduled ``engine_crash`` event fired.
        """
        m = self.metrics
        if self.coord is not None and m.steps % self.respond_every == 0:
            self._respond()
        fault_time = (self._apply_faults() if self.faults is not None
                      else 0.0)
        self._shed_expired()
        # the scheduler sees only the eligible part of the queue: deferred
        # requests wait until completions reopen the region; a draining
        # engine admits nothing until resume()
        m.queue_depth_trace.append(len(self.waiting))
        if self._draining:
            eligible = []
            self._eligible_rids = set()
        elif self.admission is not None:
            eligible, deferred = self.admission.filter(self.waiting,
                                                       self.running)
            m.admission_deferrals += len(deferred)
            self._eligible_rids = {r.rid for r in eligible}
        else:
            eligible = self.waiting
            self._eligible_rids = None
        m.occupancy_trace.append(self._occupancy_frac())
        decision = self.sched.plan(m.steps, eligible, self.running)
        lanes = [r for r in decision.run if r.prefilled and not r.done]
        pending = [r for r in decision.run if not r.prefilled]
        flops_slack = None
        if self.step_tokens is not None and lanes:
            ctx_mean = float(np.mean([r.ctx_len for r in lanes]))
            flops_slack = self.cost.piggyback_tokens(
                self.hw, len(lanes), ctx_mean, self.weight_bytes)
        chunks = split_step_budget(
            self.step_tokens, len(lanes),
            [r.prompt_positions - r.prefill_pos for r in pending],
            flops_slack=flops_slack)

        transfer_time = self._place(decision)

        self.running = [r for r in decision.run if r.slot is not None]
        self.waiting = [r for r in self.waiting + decision.preempt
                        if r.slot is None and not r.done]

        live = [r for r in self.running if not r.done and r.prefilled]
        chunk_plan = [(r, n) for r, n in zip(pending, chunks)
                      if n > 0 and r.slot is not None]
        specs = self._pick_speculative(decision, len(lanes), chunks,
                                       len(chunk_plan), flops_slack)
        compute_time, fused_transfer = self._fused_step(live, chunk_plan,
                                                        specs)
        step_time = compute_time + transfer_time + fused_transfer + fault_time

        retired = []
        for r in list(self.running):
            if r.done:
                self.running.remove(r)
                self._retire(r, "finished")
                retired.append(r)

        if self.watchdog_steps is not None:
            self._watchdog()

        step_time += self._prefetch_restores(compute_time)

        for r in self.running + retired:
            if r.generated and r.rid not in m.ttft:
                r.ttft_step = m.steps
                m.ttft[r.rid] = m.sim_time + step_time - r.arrival
        for r in retired:
            m.rct[r.rid] = m.sim_time + step_time - r.arrival

        m.sim_time += step_time
        m.steps += 1
        m.step_times.append(step_time)
        m.fairness_trace.append(
            fairness_spread(self.waiting + self.running))
        m.leg_retries = (self.pager.meter.retries_fabric
                         + self.pager.meter.retries_host)
        if self.auditor is not None:
            self.auditor.audit(self.kv, engine=self)

    # ------------------------------------------------------------------
    def _place(self, decision: Decision) -> float:
        """Park the preempted, slot and restore the scheduled. Returns the
        metered transfer time."""
        m = self.metrics
        t_before = self.pager.meter.sim_time
        if self._prefetched:
            # prefetch misprediction: re-park so LOCAL holds only the plan
            run_ids = {r.rid for r in decision.run}
            for r in self._prefetched:
                if (r.parked is None and r.slot is None and not r.done
                        and r.rid not in run_ids):
                    self.kv.park(r.rid, r.resident_tokens,
                                 prefer=self.offload_tier)
                    r.parked = True
            self._prefetched = []
        for r in decision.preempt:
            self.kv.park(r.rid, r.resident_tokens, prefer=self.offload_tier)
            r.parked = True
            self._free_slot(r)
            m.preemptions += 1
        for r in decision.run:
            if r.slot is not None:
                continue
            if not self._free_slots:
                raise SchedulingInvariantError(
                    f"{self.name}: planned run set needs a slot for request "
                    f"{r.rid} but none are free (max_running="
                    f"{self.max_running})")
            r.slot = self._free_slots.pop()
            if r.parked:
                self.kv.restore(r.rid)
                r.parked = None
                m.restores += 1
        return self.pager.meter.sim_time - t_before

    def _prefetch_restores(self, compute_time: float) -> float:
        """Restore the next plan's parked requests during this step; the
        transfer is hidden up to the step's compute time."""
        if not self.prefetch or not (self.waiting or self.running):
            return 0.0
        m = self.metrics
        # prefetch only what the admission gate lets the next plan see
        pool = (self.waiting if self._eligible_rids is None
                else [r for r in self.waiting
                      if r.rid in self._eligible_rids])
        nxt = self.sched.peek(m.steps + 1, pool, self.running)
        t_before = self.pager.meter.sim_time
        for r in nxt.run:
            if r.parked and self.kv.can_restore(r.rid):
                self.kv.restore(r.rid)
                r.parked = None
                m.restores += 1
                m.prefetched_restores += 1
                self._prefetched.append(r)
        transfer = self.pager.meter.sim_time - t_before
        if transfer <= 0.0:
            return 0.0
        visible = overlapped_transfer_time(compute_time, transfer)
        m.overlap_hidden_s += transfer - visible
        return visible

    # ------------------------------------------------------------------
    def _pick_speculative(self, decision: Decision, n_lanes: int,
                          chunks: List[int], n_chunk_rows: int = 0,
                          flops_slack: Optional[int] = None) -> List:
        """Speculative chunk-ahead: budget slack left after every admitted
        prefill is fully granted goes to WAITING prefills in arrival order,
        each grant capped at ``remaining - 1`` positions, worth at least
        one page, page-headroom guarded and within the fixed row bucket.
        Returns ``(request, n_tokens)`` grants."""
        if not self.spec_chunk_ahead or self.step_tokens is None:
            return []
        slack = self.step_tokens - n_lanes - sum(chunks)
        if flops_slack is not None:
            slack = min(slack, max(int(flops_slack) - sum(chunks), 0))
        if slack < self.kv.page_tokens:
            return []
        max_rows = bucket_tokens(self.max_running + 1, lo=1) - n_chunk_rows
        skip = {r.rid for r in decision.run}
        skip.update(r.rid for r in decision.preempt)
        cands = sorted((r for r in self.waiting
                        if r.rid not in skip and not r.prefilled
                        and not r.done and r.slot is None
                        and (self._eligible_rids is None
                             or r.rid in self._eligible_rids)),
                       key=lambda r: (r.arrival, r.rid))
        free = np.asarray([p.aqua.local_free
                           for p in self.kv.planes.values()], np.int64)
        picks: List = []
        for r in cands:
            if len(picks) >= max_rows or slack < self.kv.page_tokens:
                break
            n = min(slack, r.prompt_positions - 1 - r.prefill_pos)
            if n < self.kv.page_tokens:
                continue
            need = self.kv.pages_per_request(r.prefill_pos + n)
            if np.all(need <= free):
                picks.append((r, n))
                slack -= n
                free = free - need
        return picks

    def _fused_step(self, live: List[ReqState], chunk_plan: List,
                    specs: List) -> tuple:
        """Pack the step's work into one ``api.serve_step_paged`` call.

        Rows ``[0, max_running)`` are the decode lanes (when any resident
        request decodes; idle lanes point at scratch), then one prompt
        chunk per row — run-set chunks plus speculative grants —
        bucket-padded in both axes. Returns ``(compute_time,
        metered_transfer_time)`` on the analytic clock."""
        m = self.metrics
        rows_chunk = list(chunk_plan) + list(specs)
        spec_rids = {r.rid for r, _ in specs}
        if not live and not rows_chunk:
            m.prefill_tokens_trace.append(0)
            m.launch_trace.append(0)
            m.baseline_launch_trace.append(0)
            return 0.0, 0.0
        t_before = self.pager.meter.sim_time
        n_dec = self.max_running if live else 0
        if not rows_chunk:
            Tc, Rp = 1, 0
        elif self.step_tokens is not None:
            Tc = bucket_tokens(self.step_tokens)
            Rp = bucket_tokens(self.max_running + 1, lo=1)
        else:
            Tc = bucket_tokens(max(n for _, n in rows_chunk))
            Rp = bucket_tokens(len(rows_chunk), lo=1)
        R = n_dec + Rp
        tokens = np.zeros((R, Tc), np.int32)
        q_starts = np.zeros((R,), np.int32)
        n_reals = np.zeros((R,), np.int32)
        row_rids: List[Optional[int]] = [None] * R
        if live:
            n_reals[:n_dec] = 1              # idle lanes: token 0 at pos 0
            ctx_mean = float(np.mean([r.ctx_len for r in live]))
            for r in live:
                # the new token may cross into a fresh page (allocation is
                # LOCAL); an append into a still-shared page clones it
                self.kv.ensure_capacity(r.rid, r.ctx_len)
                self.kv.make_writable(r.rid, r.ctx_len - 1, r.ctx_len)
                row_rids[r.slot] = r.rid
                tokens[r.slot, 0] = (r.generated[-1] if r.generated
                                     else r.prompt_tokens[-1])
                q_starts[r.slot] = r.ctx_len - 1
        for j, (r, n) in enumerate(rows_chunk):
            row = n_dec + j
            start = r.prefill_pos
            if r.rid in spec_rids:
                if r.parked:
                    m.spec_restores += 1
                try:
                    self.kv.ensure_capacity(r.rid, start + n)
                except MemoryError:
                    # the run set's own growth beat the advisory headroom
                    # check: drop this grant and every later one
                    self.kv.park(r.rid, r.prefill_pos,
                                 prefer=self.offload_tier)
                    r.parked = True
                    specs = specs[:j - len(chunk_plan)]
                    rows_chunk = rows_chunk[:j]
                    break
            else:
                self.kv.ensure_capacity(r.rid, start + n)
            self.kv.make_writable(r.rid, start, start + n)
            row_rids[row] = r.rid
            tokens[row, :n] = np.asarray(r.prompt_tokens[start:start + n],
                                         np.int32)
            q_starts[row] = start
            n_reals[row] = n
        bt = self.kv.block_tables(row_rids, pad_to=self._pps_pad)
        logits, self.kv.pools = api.serve_step_paged(
            self.params, self.cfg, tokens, self.kv.pools, bt, q_starts,
            n_reals, n_decode=n_dec, read_pps=self.kv.pps)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()

        compute = 0.0
        ptoks = 0
        for j, (r, n) in enumerate(rows_chunk):
            r.prefill_pos += n
            self.kv.register_prefix(r.rid, r.prefill_pos)
            if r.prefilled:
                r.generated.append(int(nxt[n_dec + j]))
            m.prefills += 1
            ptoks += n
        for r, n in specs:
            m.spec_chunks += 1
            m.spec_tokens += n
            # a speculative request is not in the run set: hand its pages
            # straight back so LOCAL holds only that set
            self.kv.park(r.rid, r.prefill_pos, prefer=self.offload_tier)
            r.parked = True
        if live:
            for r in live:
                r.generated.append(int(nxt[r.slot]))
            compute += self.cost.fused_step_time(self.hw, len(live),
                                                 ctx_mean,
                                                 self.weight_bytes, ptoks)
        elif ptoks:
            compute += self.cost.prefill_time(self.hw, ptoks)
        compute += self.cost.launch_time(self.hw, 1)
        m.prefill_tokens_trace.append(ptoks)
        m.launch_trace.append(self.cost.n_layers)
        m.baseline_launch_trace.append(
            (len(rows_chunk) + (1 if live else 0)) * self.cost.n_layers)
        return compute, self.pager.meter.sim_time - t_before

    # ------------------------------------------------------------------
    def run(self, max_steps: int = 1000):
        """Step until every submitted request finished (or ``max_steps``);
        honours pending coordinator reclaims before returning. Returns the
        engine's :class:`EngineMetrics`."""
        for _ in range(max_steps):
            if not (self.waiting or self.running):
                break
            self.step()
        if self.coord is not None:
            self._respond()        # no lease left dangling after the drain
        return self.metrics

    # ------------------------------------------------------------------
    # crash-consistent snapshot / restore
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        """Serialize the whole serving state to a plain dict in host memory:
        the journal record a crash-consistent restart replays.

        It carries the constructor knobs that size an equal engine, every
        request (waiting, running and finished: prompts, generated tokens,
        prefill positions, deadlines, terminal stamps), the runtime's page
        state (:meth:`PagedStateRuntime.snapshot_state`: block tables, page
        payloads as host numpy, the radix tree), the admitted set, the CFS
        slice phase, the drain gate and the metrics. It holds no device
        tensor. Greedy decoding has no sampler state to carry.

        Read-only; call between steps. Remote leases are not serialized:
        restored pages land on HOST and the restored engine leases donor
        memory through its own constructor.

        Raises:
            PageLossError: a block table still references a LOST page.
        """
        def req(r: ReqState) -> Dict:
            return {"rid": r.rid, "arrival": r.arrival,
                    "prompt_tokens": list(r.prompt_tokens),
                    "max_new_tokens": r.max_new_tokens,
                    "generated": list(r.generated),
                    "prefill_pos": r.prefill_pos,
                    "n_prefix": r.n_prefix,
                    "prefix_embeds": None,     # the port serves no VLM
                    "shared_tokens": r.shared_tokens,
                    "ttft_step": r.ttft_step,
                    "finish_step": r.finish_step,
                    "lora_id": r.lora_id,
                    "deadline_s": r.deadline_s,
                    "ttft_deadline_s": r.ttft_deadline_s,
                    "terminal": r.terminal,
                    "cancel_reason": r.cancel_reason}

        metrics: Dict[str, object] = {}
        for f in dataclass_fields(EngineMetrics):
            v = getattr(self.metrics, f.name)
            metrics[f.name] = (dict(v) if isinstance(v, dict)
                               else list(v) if isinstance(v, list) else v)
        return {"version": 1,
                "config": dict(self._snap_knobs),
                "next_rid": self._next_rid,
                "running": [req(r) for r in self.running],
                "waiting": [req(r) for r in self.waiting],
                "finished": [req(r) for r in self.finished],
                "kv": self.kv.snapshot_state(),
                "admitted": (sorted(self.admission.admitted_rids)
                             if self.admission is not None else None),
                "since_switch": getattr(self.sched, "_since_switch", None),
                "draining": self._draining,
                "metrics": metrics}

    @classmethod
    def restore(cls, cfg: ModelConfig, params, snapshot: Dict, *,
                faults=None, coordinator: Optional[Coordinator] = None,
                audit: bool = False, hw: HardwareProfile = H100_SXM,
                device=None, **overrides) -> "ServingEngine":
        """Rebuild a serving engine from a :meth:`snapshot` dict.

        A fresh engine is built on ``device`` (CUDA unless the caller passes
        another; raises when CUDA is absent) from the snapshot's knobs, with
        ``overrides`` winning: pass ``kv=<a fresh PagedStateRuntime>`` where
        the default geometry cannot hold the snapshot (a snapshot carries no
        ``n_logical``, and every page lands on HOST first). The runtime's
        page state is rebuilt payload for payload
        (:meth:`PagedStateRuntime.restore_state`) and every surviving
        request re-queues, former runners first, parked exactly when it
        still owns pages. The finished list, metrics, admitted set, CFS
        slice phase and drain gate carry over. Restored requests finish
        with the tokens an uninterrupted run gives wherever the forward is
        invariant to how the run is cut into steps (greedy argmax, exact
        park/restore round trips). Audit a restored engine with a new
        :class:`InvariantAuditor`.
        """
        knobs = dict(snapshot["config"])
        knobs.update(overrides)
        eng = cls(cfg, params, faults=faults, coordinator=coordinator,
                  audit=audit, hw=hw, device=device, **knobs)
        eng.kv.restore_state(snapshot["kv"])

        def req(d: Dict) -> ReqState:
            r = ReqState(d["rid"], d["arrival"], list(d["prompt_tokens"]),
                         d["max_new_tokens"], lora_id=d["lora_id"],
                         deadline_s=d["deadline_s"],
                         ttft_deadline_s=d["ttft_deadline_s"])
            r.generated = list(d["generated"])
            r.prefill_pos = d["prefill_pos"]
            r.n_prefix = d["n_prefix"]
            r.shared_tokens = d["shared_tokens"]
            r.ttft_step = d["ttft_step"]
            r.finish_step = d["finish_step"]
            r.terminal = d["terminal"]
            r.cancel_reason = d["cancel_reason"]
            if any(r.rid in p.pages for p in eng.kv.planes.values()):
                r.parked = True      # its pages sit on the host tier
            return r

        eng.waiting = ([req(d) for d in snapshot["running"]]
                       + [req(d) for d in snapshot["waiting"]])
        eng.finished = [req(d) for d in snapshot["finished"]]
        eng._next_rid = int(snapshot["next_rid"])
        eng._draining = bool(snapshot["draining"])
        if eng.admission is not None and snapshot["admitted"] is not None:
            eng.admission._admitted = set(snapshot["admitted"])
        if (snapshot["since_switch"] is not None
                and hasattr(eng.sched, "_since_switch")):
            eng.sched._since_switch = snapshot["since_switch"]
        for k, v in snapshot["metrics"].items():
            setattr(eng.metrics, k, dict(v) if isinstance(v, dict)
                    else list(v) if isinstance(v, list) else v)
        return eng
