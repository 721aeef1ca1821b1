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

Not ported yet, and refused by the constructor's signature: admission
control, the mesh tier domain, the watchdog and the ``paged_impl`` switch;
cancellation, deadlines, drain, snapshot/restore and clock calibration are
absent, and a ``cancel`` or ``engine_crash`` fault event raises
``NotImplementedError``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.aqua_tensor import REMOTE
from repro_torch.core.coordinator import Coordinator
from repro_torch.core.device import resolve_device
from repro_torch.core.errors import SchedulingInvariantError
from repro_torch.core.faults import InvariantAuditor
from repro_torch.core.perfmodel import (H100_SXM, HardwareProfile, ModelCost,
                                        overlapped_transfer_time)
from repro_torch.models import api
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
    submitted: int = 0


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
                 faults=None, audit: bool = False, device=None):
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
                plane; its step-scheduled lease shrinks and donor losses
                apply at the top of each step.
            audit: run ``InvariantAuditor`` after every step.
            device: serving device; CUDA unless the caller passes another
                (raises when CUDA is requested and absent).

        Raises:
            ValueError: the family is not paged-servable, or
                ``step_tokens < 8``.
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
        self.faults = faults
        if faults is not None:
            self.kv.attach_faults(faults)
        self.auditor = InvariantAuditor() if audit else None

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

    def _page_cost_fcfs(self, r: ReqState,
                        chosen: Sequence[ReqState] = ()) -> np.ndarray:
        """FCFS never preempts: budget the full remaining generation."""
        remaining = r.max_new_tokens - len(r.generated)
        base = self.kv.pages_per_request(
            min(r.ctx_len + max(remaining, 0), self.max_seq))
        return base - self._shared_discount(r, chosen)

    # ------------------------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: int,
               arrival: float = 0.0,
               lora_id: Optional[int] = None) -> ReqState:
        """Queue a request for generation; with prefix sharing on, its
        longest page-aligned prompt prefix already on pages is adopted and
        prefill starts past it (at least the last position is recomputed).

        Args:
            prompt_tokens: prompt token ids.
            max_new_tokens: tokens to generate before the request retires.
            arrival: arrival time on the simulated clock.
            lora_id: prefix-index partition key.

        Returns:
            The queued :class:`ReqState`.
        """
        r = ReqState(self._next_rid, arrival, list(map(int, prompt_tokens)),
                     max_new_tokens, lora_id=lora_id)
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

    # teardown helpers: retirement and lost-page recovery share them
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

    def _retire(self, r: ReqState) -> None:
        """The one exit: free the slot, release the pages, move the request
        to ``finished``."""
        self._free_slot(r)
        self._release_pages(r)
        r.parked = None
        r.terminal = "finished"
        r.finish_step = self.metrics.steps
        self.finished.append(r)

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
        m.recomputes += 1
        m.recovered_rids.append(rid)

    def _apply_faults(self) -> float:
        """Apply the injector's events due at this step: a ``lease_shrink``
        live-migrates the reclaimed slots' pages, a ``donor_loss`` sends
        every victim through :meth:`_recover_lost`; then re-plan the
        budget. Returns the metered transfer time of the recovery moves.

        Raises:
            NotImplementedError: a ``cancel`` or ``engine_crash`` event (the
                request lifecycle is not ported yet).
        """
        m = self.metrics
        t_before = self.pager.meter.sim_time
        fired = False
        for ev in self.faults.due_events(step=m.steps, now=m.sim_time):
            if ev.kind in ("cancel", "engine_crash"):
                raise NotImplementedError(
                    f"{self.name}: a {ev.kind!r} fault event needs the "
                    "request lifecycle (cancel, snapshot/restore), not "
                    "ported yet (ROADMAP queue 1 item 5)")
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
        ``respond_every`` steps and apply due fault events, plan the run
        set (``sched.plan`` under the page budget), park the preempted and
        slot + restore the scheduled (``_place``), run every decode token
        and every fair-share prompt chunk in one fused call
        (``_fused_step``), retire finished requests and prefetch the next
        step's restores; with ``audit``, audit the runtime. Metrics accrue
        on ``self.metrics``.

        Raises:
            SchedulingInvariantError: the plan needs more batch slots than
                exist.
            MemoryError: a page allocation or tier flip found its tier full.
        """
        m = self.metrics
        if self.coord is not None and m.steps % self.respond_every == 0:
            self._respond()
        fault_time = (self._apply_faults() if self.faults is not None
                      else 0.0)
        decision = self.sched.plan(m.steps, self.waiting, self.running)
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
                self._retire(r)
                retired.append(r)

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
        nxt = self.sched.peek(m.steps + 1, self.waiting, self.running)
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
                        and not r.done and r.slot is None),
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
