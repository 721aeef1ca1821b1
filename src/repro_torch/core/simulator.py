"""Discrete-event serving simulator priced by ``core/perfmodel.py`` — the
reference's ``repro/core/simulator.py`` kept as the port's own copy (numpy
only).

The scheduling logic (FCFS or CFS admission, chunked prefill, paging
decisions, prefix adoption, admission control, fault schedules) is the
serving engine's; only the kernels' wall times are analytic. It reproduces
the paper's end-to-end serving figures for a hardware profile: CFS against
vLLM-style FCFS (Fig. 9), the fabric tier against the host tier (Fig. 1b)
and long-prompt decode throughput (Fig. 7).

Schedulers:
  * ``vllm``      — continuous batching, FCFS admission gated on KV memory
                    (requests queue, possibly starving: paper Fig. 1a).
  * ``cfs``       — completely fair scheduling: token time-slices; at each
                    slice boundary the `max_running` prompts with the FEWEST
                    generated tokens run next (paper §5). Preempted prompts'
                    contexts page out; scheduled prompts' contexts page in.
                    ``offload_tier`` decides where: 'host' (PCIe) or
                    'fabric' (AQUA TENSORS over the scale-up fabric).

``Request`` is the record of ``core/workload.py``; ``simulator.Request``
names the same class.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.errors import CapacityError
from repro_torch.core.perfmodel import (HardwareProfile, ModelCost,
                                        context_switch_time,
                                        overlapped_transfer_time,
                                        page_flip_time, retry_backoff_time)
from repro_torch.core.workload import Request
from repro_torch.serving.scheduler import split_step_budget


@dataclass
class SimResult:
    requests: List[Request]
    timeline: List[Dict] = field(default_factory=list)

    def ttfts(self):
        return [r.ttft - r.arrival for r in self.requests if r.ttft is not None]

    def rcts(self):
        return [r.finish - r.arrival for r in self.requests if r.finish is not None]

    def p50(self, xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else float("nan")


class ServingSimulator:
    def __init__(self, hw: HardwareProfile, model: ModelCost, *,
                 weight_bytes: float, kv_capacity_bytes: float,
                 scheduler: str = "vllm", offload_tier: str = "host",
                 slice_tokens: int = 5, max_running: int = 16,
                 coalesced: bool = True, paging: str = "paged",
                 step_tokens: Optional[int] = None,
                 overlap_pagein: bool = False,
                 fused_step: bool = True,
                 spec_chunk_ahead: bool = False,
                 coalesce_planes: bool = True,
                 prefix_cache: bool = True,
                 lora_cache_bytes: float = 0.0,
                 lora_num_adapters: int = 200,
                 faults=None,
                 admission: bool = False,
                 admission_headroom: float = 0.9,
                 prefill_admit_limit: Optional[int] = 4):
        self.hw = hw
        self.model = model
        self.weight_bytes = weight_bytes
        self.kv_cap = kv_capacity_bytes
        self.scheduler = scheduler
        self.tier = offload_tier
        self.slice_tokens = slice_tokens
        self.max_running = max_running
        self.coalesced = coalesced
        # step_tokens: chunked continuous-batching prefill — each scheduler
        # round spends at most this many tokens (+1 progress floor), split
        # between the round's decode iterations (lanes x slice for CFS) and
        # prompt chunks (None = whole-prompt prefill, the seed behavior).
        self.step_tokens = step_tokens
        # overlap_pagein: price CFS page-ins as prefetched transfers hidden
        # up to the round's compute time (perfmodel.overlapped_transfer_time)
        self.overlap_pagein = overlap_pagein
        # fused_step: the one-launch engine step — every decode iteration is
        # ONE jitted call carrying all requests' chunks, so dispatch
        # overhead per round is O(decode iterations); the per-request
        # baseline adds one call per granted chunk (O(admitted requests),
        # the Kossmann et al. between-launch idle regime). Priced by
        # ModelCost.launch_time.
        self.fused_step = fused_step
        # spec_chunk_ahead: leftover step-token slack speculatively prefills
        # the head-of-line waiting prompt (parked again right after) —
        # mirrors the engine's speculative chunk-ahead.
        self.spec_chunk_ahead = spec_chunk_ahead
        # coalesce_planes: a multi-plane (SSM/hybrid) context switch fuses
        # every plane into one message per (tier, donor); uncoalesced it
        # pays ModelCost.n_planes messages (the pre-fusion runtime).
        self.coalesce_planes = coalesce_planes
        # prefix_cache: the global radix prefix cache — a FINISHED group
        # member's written prefix stays adoptable (the runtime retains
        # refcount-0 pages until page pressure evicts them), so a later
        # arrival skips those prefill tokens and pays only the restore
        # bytes of the cached prefix on its first page-in. Off, adoption
        # requires a LIVE member (pure CoW sharing, the pre-cache model).
        self.prefix_cache = bool(prefix_cache)
        self.cache_hits = 0              # adoptions satisfied only by a
        self.cache_hit_tokens = 0        # finished member's cached pages
        self.adopted_tokens = 0          # prefill tokens skipped by ANY
        #                                  adoption (live-shared or cached)
        # 'paged': decode KV lives on pages; a context switch is a page-table
        # tier flip (no repack gather — matches the paged ServingEngine).
        # 'blob': the seed path — gather every leaf into a staging blob first.
        self.paging = paging
        self.lora_cache = lora_cache_bytes
        self.lora_num_adapters = lora_num_adapters
        # faults: optional core/faults.FaultInjector on the ANALYTIC clock —
        # transfer legs pay Bernoulli retry+backoff time, and time-scheduled
        # FaultEvents (at_time) fire at round boundaries: a donor_loss resets
        # its fraction of parked contexts to recompute from the prompt, a
        # lease_shrink degrades that fraction of future fabric flip bytes to
        # the host link (the reclaimed donor slots' pages now live on host)
        self.faults = faults
        self.leg_retries = 0
        self.donor_losses = 0
        self.lease_shrinks = 0
        # request-lifecycle counters (mirror EngineMetrics): teardowns
        # before completion and the deadline-expiry subset
        self.cancelled = 0
        self.deadline_missed = 0
        self._host_spill = 0.0
        # prefix sharing only exists for all-token-plane families: a
        # recurrent state page summarizes the whole prefix and cannot be
        # aliased (PagedStateRuntime forces sharing off when state_bytes>0),
        # so the simulator ignores prefix groups for those models
        self.prefix_sharing_ok = model.state_bytes == 0.0
        # overflow-swap churn (vllm branch): admission gates on CURRENT
        # bytes, but contexts grow one token per decode step — when the
        # admitted set's growth overshoots kv_cap, the latest-arrived
        # resident swaps out (vLLM swap preemption) and re-admits later,
        # paying the flip both ways. This is Ao et al.'s service-induced
        # congestion: churn rises exactly when load spikes. The stability
        # controller below exists to price TERMINAL bytes so it never fires.
        self.overflow_swaps = 0
        # admission: the SLO-aware stability-region controller of
        # serving/admission.py on the BYTE clock — one implementation, two
        # clocks (the engine instantiates it over per-plane page vectors).
        # Deferred requests stay queued (degrade-to-queue), invisible to
        # both scheduler branches until completions reopen the region.
        self.admission = None
        if admission:
            from repro_torch.serving.admission import AdmissionController
            self.admission = AdmissionController(
                budget=lambda: np.array([self.kv_cap]),
                current_cost=lambda r, chosen: self._adm_cost(
                    r, chosen, terminal=False),
                terminal_cost=lambda r, chosen: self._adm_cost(
                    r, chosen, terminal=True),
                remaining_tokens=lambda r: (r.prompt_len - r.prefill_pos,
                                            r.gen_len - r.generated),
                headroom=admission_headroom,
                step_tokens=self.step_tokens,
                prefill_admit_limit=prefill_admit_limit)

    def _adm_cost(self, r: Request, chosen, *, terminal: bool) -> np.ndarray:
        """Marginal context bytes of ``r`` against the committed set — at
        the current context, or grown to completion (``terminal``), the
        quantity naive current-bytes admission ignores."""
        ctx = r.prompt_len + (r.gen_len if terminal else r.generated)
        groups = {c.prefix_group for c in chosen
                  if c.prefix_group is not None}
        if (self.prefix_sharing_ok and r.prefix_group is not None
                and r.prefix_group in groups):
            return np.array([self.model.unique_context_bytes(
                ctx, min(r.shared_prefix_len, r.prompt_len))])
        return np.array([self.model.context_bytes(ctx)])

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], *, horizon: float = 1e9) -> SimResult:
        t = 0.0
        pending: List[Request] = sorted(requests, key=lambda r: r.arrival)
        waiting: List[Request] = []
        running: List[Request] = []
        done: List[Request] = []
        timeline = []

        def kv_bytes(r: Request) -> float:
            # whole dynamic context: token-paged KV/latents + the fixed
            # recurrent state planes (nonzero for SSM/hybrid families)
            return self.model.context_bytes(r.prompt_len + r.generated)

        def marginal_bytes(r: Request, groups) -> float:
            # dedup-aware admission: a member of a prefix group whose shared
            # pages are already counted (another member in `groups`) costs
            # only its exclusive context
            if (self.prefix_sharing_ok and r.prefix_group is not None
                    and r.prefix_group in groups):
                return self.model.unique_context_bytes(
                    r.prompt_len + r.generated,
                    min(r.shared_prefix_len, r.prompt_len))
            return kv_bytes(r)

        def used_bytes() -> float:
            groups, total = set(), 0.0
            for r in running:
                if r.resident:
                    total += marginal_bytes(r, groups)
                    if r.prefix_group is not None:
                        groups.add(r.prefix_group)
            return total

        def resident_groups() -> set:
            return {r.prefix_group for r in running
                    if r.resident and r.prefix_group is not None}

        if self.kv_cap <= 0:
            raise CapacityError(
                "model does not fit this serving unit (use "
                "HardwareProfile.pod_slice for TP-sharded serving)")
        stall = 0
        while (pending or waiting or running) and t < horizon:
            # fire time-scheduled fault events due on the analytic clock
            if self.faults is not None:
                for ev in self.faults.due_events(now=t):
                    if ev.kind == "donor_loss":
                        self.donor_losses += 1
                        victims = [r for r in waiting
                                   if not r.resident and r.finish is None
                                   and (r.prefill_pos > 0 or r.generated > 0)]
                        n = math.ceil(ev.frac * len(victims))
                        for r in victims[:n]:
                            # parked pages died with the donor: recompute
                            # from the prompt (TTFT stands — the first token
                            # was already served; only remaining work re-runs)
                            r.generated = 0
                            r.prefill_pos = 0
                            r.prefilled = False
                            r.recovered = True
                            if self.admission is not None:
                                # reset work must re-price against the
                                # (possibly contracted) stability region
                                self.admission.forget(r.rid)
                    elif ev.kind == "lease_shrink":
                        self.lease_shrinks += 1
                        self._host_spill = min(
                            1.0, self._host_spill + ev.frac)
                    elif ev.kind == "cancel":
                        # client abandonment (make_cancel_events): tear the
                        # named request out of whichever pool holds it —
                        # same schedule, both clocks
                        for pool in (running, waiting, pending):
                            v = next((x for x in pool if x.rid == ev.rid),
                                     None)
                            if v is None:
                                continue
                            pool.remove(v)
                            v.cancelled, v.cancel_reason = True, "fault"
                            v.resident = False
                            self.cancelled += 1
                            if self.admission is not None:
                                self.admission.forget(v.rid)
                            break
            # admit arrivals. Prefix sharing adopts at arrival (mirroring
            # the engine's submit-time index lookup): an arriving member of
            # a prefix group whose shared prefix some member already wrote
            # skips those chunks (>= 1 position remains for the first-token
            # logits, as in the engine).
            while pending and pending[0].arrival <= t:
                r = pending.pop(0)
                skip = min(r.shared_prefix_len, r.prompt_len - 1)
                # adoptable from a member that STILL HOLDS pages covering
                # the skipped prefix (live CoW sharing), or — with the
                # prefix cache on — from a FINISHED member whose refcount-0
                # pages the runtime retained (a cache hit: the prefill
                # tokens are skipped, only restore bytes are paid below)
                if (self.prefix_sharing_ok and r.prefix_group is not None
                        and skip > 0):
                    live = any(o is not r
                               and o.prefix_group == r.prefix_group
                               and o.finish is None
                               and o.prefill_pos >= skip
                               for o in requests)
                    cached = (self.prefix_cache
                              and any(o is not r
                                      and o.prefix_group == r.prefix_group
                                      and o.finish is not None
                                      and o.prefill_pos >= skip
                                      for o in requests))
                    if live or cached:
                        r.prefill_pos = skip
                        self.adopted_tokens += skip
                        if not live:
                            self.cache_hits += 1
                            self.cache_hit_tokens += skip
                waiting.append(r)
            # deadline sweep (mirrors the engine's _shed_expired): expired
            # waiters are shed before admission can see them, expired
            # runners drop their residency the same round. TTFT deadlines
            # bind only until the first token landed.
            for r in list(waiting) + list(running):
                age = t - r.arrival
                ttft_miss = (r.ttft_deadline_s is not None and r.ttft is None
                             and age > r.ttft_deadline_s)
                e2e_miss = r.deadline_s is not None and age > r.deadline_s
                if not (ttft_miss or e2e_miss):
                    continue
                (waiting if r in waiting else running).remove(r)
                r.cancelled, r.cancel_reason = True, "deadline"
                r.resident = False
                self.cancelled += 1
                self.deadline_missed += 1
                if self.admission is not None:
                    self.admission.forget(r.rid)
            if not running and not waiting:
                t = pending[0].arrival
                continue
            # reject requests whose context alone exceeds capacity
            if not running and waiting and not pending:
                stall += 1
                if stall > 3:
                    for r in list(waiting):
                        if kv_bytes(r) > self.kv_cap:
                            waiting.remove(r)
                    if not waiting:
                        break
            else:
                stall = 0

            # stability-region admission gate: deferred requests are
            # invisible to BOTH scheduler branches this round (degrade to
            # queue); they retry every round and admit as completions free
            # bytes. Without it every waiter is eligible.
            deferred: List[Request] = []
            sched_wait = waiting
            if self.admission is not None:
                sched_wait, deferred = self.admission.filter(waiting, running)

            step_time = 0.0
            pagein_time = 0.0
            if self.scheduler == "vllm":
                # overflow preemption churn: admission gated on CURRENT
                # bytes, but last round's decode growth may have pushed the
                # resident set past kv_cap. vLLM's default preemption
                # RECOMPUTES: the latest-arrived resident discards its KV
                # (free — no transfer) and must re-prefill its whole prompt
                # when re-admitted (at least one request keeps running).
                # Under a spike this thrashes: the newest residents are
                # evicted before their first token, re-admit, re-prefill a
                # few chunks, get evicted again — Ao et al.'s
                # service-induced congestion, the TTFT divergence the
                # stability controller exists to prevent (it prices
                # TERMINAL bytes, so the overshoot never happens).
                while (used_bytes() > self.kv_cap
                       and sum(1 for r in running if r.resident) > 1):
                    victim = max((r for r in running if r.resident),
                                 key=lambda r: (r.arrival, r.rid))
                    victim.resident = False
                    # the rebuild covers the WHOLE context: prompt plus the
                    # KV of every token generated so far (the generated
                    # text is kept; its cache is not) — encoded as negative
                    # prefill_pos so prompt_len - prefill_pos is the
                    # remaining rebuild work
                    victim.prefill_pos = -victim.generated
                    victim.prefilled = False
                    running.remove(victim)
                    waiting.append(victim)
                    if sched_wait is not waiting:
                        # still admitted — stays eligible for re-admission
                        sched_wait.append(victim)
                    self.overflow_swaps += 1
                # FCFS admission while KV fits (physical bytes: a shared
                # prefix already resident via its group is not re-counted)
                for r in list(sched_wait):
                    if used_bytes() + marginal_bytes(r, resident_groups()) \
                            <= self.kv_cap \
                            and len(running) < self.max_running:
                        waiting.remove(r)
                        # a non-resident written context pages in on
                        # admission: a recovered request's prefix, or an
                        # adopted (cached) prefix — pinned to zero bytes
                        # when a live group member already holds it LOCAL
                        if not r.resident and (r.prefilled
                                               or r.prefill_pos > 0):
                            pinned = (r.prefix_group is not None
                                      and r.prefix_group
                                      in resident_groups())
                            pagein_time += self._switch_time(
                                r, direction="in", shared_pinned=pinned)
                        r.resident = True
                        running.append(r)
                ntok = 1
            else:  # cfs
                # slice boundary: fair-pick the least-served prompts under
                # the PHYSICAL byte budget (marginal cost per prefix group);
                # deferred requests never enter the fair pick
                candidates = running + sched_wait
                candidates.sort(key=lambda r: (r.generated, r.arrival))
                nxt = []
                acc = 0.0
                groups: set = set()
                for r in candidates:
                    b = marginal_bytes(r, groups)
                    if acc + b > self.kv_cap or len(nxt) >= self.max_running:
                        continue
                    acc += b
                    nxt.append(r)
                    if r.prefix_group is not None:
                        groups.add(r.prefix_group)
                # page out the preempted, page in the scheduled. A shared
                # prefix moves ONCE per group: it stays pinned while any
                # member remains scheduled, and when a whole group parks,
                # only the first member's switch carries the prefix bytes.
                nxt_groups = {r.prefix_group for r in nxt
                              if r.prefix_group is not None}
                moved_groups: set = set()
                for r in running:
                    if r not in nxt and r.resident:
                        pinned = (r.prefix_group is not None
                                  and (r.prefix_group in nxt_groups
                                       or r.prefix_group in moved_groups))
                        step_time += self._switch_time(r, direction="out",
                                                       shared_pinned=pinned)
                        if r.prefix_group is not None:
                            moved_groups.add(r.prefix_group)
                        r.resident = False
                in_groups = {r.prefix_group for r in nxt
                             if r.resident and r.prefix_group is not None}
                for r in nxt:
                    # anything with resident KV pays the page-in: a request
                    # parked MID-prefill moves its prefill_pos-token prefix
                    # (minus a shared prefix some member already restored)
                    if not r.resident and (r.prefilled or r.prefill_pos > 0):
                        pinned = (r.prefix_group is not None
                                  and r.prefix_group in in_groups)
                        pagein_time += self._switch_time(r, direction="in",
                                                         shared_pinned=pinned)
                    r.resident = True
                    if r.prefix_group is not None:
                        in_groups.add(r.prefix_group)
                waiting = [r for r in candidates if r not in nxt] + deferred
                running = nxt
                ntok = self.slice_tokens
            if not self.overlap_pagein:
                # seed accounting: page-ins serialize before compute
                step_time += pagein_time
                pagein_time = 0.0

            if not running:
                # nothing fits / nothing to do; advance to next arrival
                t = pending[0].arrival if pending else t + 1e-3
                continue

            # prefill under the ROUND token budget: decode lanes reserve one
            # token per decode iteration of this round (a CFS round decodes
            # `slice_tokens` per lane), the rest is handed out as prompt
            # chunks (None = whole prompts, the seed behavior)
            compute_time = 0.0
            n_chunk_calls = 0
            piggyback_tokens = 0        # chunk FLOPs riding fused decode
            lanes = [r for r in running
                     if r.prefilled and r.generated < r.gen_len]
            pend = [r for r in running if not r.prefilled]
            # roofline-aware chunk cap (mirrors the engine): piggybacked
            # chunk FLOPs spread across the round's ntok fused decode
            # iterations, each hiding up to its memory-bound FLOPs slack,
            # so the round's chunk budget is capped at the per-iteration
            # window times the planned iterations — tokens beyond it would
            # extend the round linearly instead of riding the stream free
            flops_slack = None
            if self.fused_step and lanes and self.step_tokens is not None:
                ctx0 = (sum(r.prompt_len + r.generated for r in lanes)
                        / len(lanes))
                flops_slack = ntok * self.model.piggyback_tokens(
                    self.hw, len(lanes), ctx0, self.weight_bytes)
            chunks = split_step_budget(self.step_tokens, len(lanes) * ntok,
                                       [r.prompt_len - r.prefill_pos
                                        for r in pend],
                                       flops_slack=flops_slack)
            for r, c in zip(pend, chunks):
                if c <= 0:
                    continue
                n_chunk_calls += 1
                if self.fused_step and lanes:
                    # fused one-launch step: the chunk shares the decode
                    # iteration's weight pass — its FLOPs fold into that
                    # iteration's roofline max below
                    piggyback_tokens += c
                    dt = 0.0
                else:
                    dt = self.model.prefill_time(self.hw, c)
                r.prefill_pos += c
                if r.prefill_pos >= r.prompt_len:
                    r.prefilled = True
                    dt += self._lora_load_time(r)
                compute_time += dt
                step_time += dt

            # speculative chunk-ahead: leftover budget slack prefills
            # WAITING prompts (all but each one's last position) — arrival
            # order, extending PAST the head-of-line waiter while slack
            # lasts — whose pages flip back out right after; mirrors the
            # engine. The win is largest under FCFS admission, where
            # waiters can sit slot-blocked behind long decodes for many
            # slack-rich rounds. The slack is capped by the same FLOPs
            # piggyback window as the granted chunks.
            if self.spec_chunk_ahead and self.step_tokens is not None:
                slack = (self.step_tokens - len(lanes) * ntok - sum(chunks))
                if flops_slack is not None:
                    slack = min(slack, max(flops_slack - sum(chunks), 0))
                n_groups = (1 if self.coalesce_planes
                            else self.model.n_planes)
                for spec in sorted(waiting,
                                   key=lambda r: (r.arrival, r.rid)):
                    if slack <= 0:
                        break
                    if spec.prefilled:
                        continue
                    if (self.admission is not None
                            and spec.rid not in self.admission.admitted_rids):
                        # never speculate on unadmitted work: its pages
                        # would land inside the region the controller is
                        # holding open
                        continue
                    c = min(slack, spec.prompt_len - spec.prefill_pos - 1)
                    if c <= 0:
                        continue
                    if spec.prefill_pos > 0:        # page its prefix back in
                        step_time += page_flip_time(
                            self.hw,
                            self.model.context_bytes(spec.prefill_pos),
                            tier=self.tier, n_groups=n_groups)
                    if self.fused_step and lanes:
                        # the speculative chunk rides the fused decode
                        # launch too — its FLOPs hide under the
                        # memory-bound stream below
                        piggyback_tokens += c
                    else:
                        dt = self.model.prefill_time(self.hw, c)
                        compute_time += dt
                        step_time += dt
                    spec.prefill_pos += c
                    n_chunk_calls += 1
                    slack -= c
                    step_time += page_flip_time(   # park it again
                        self.hw,
                        self.model.context_bytes(spec.prefill_pos),
                        tier=self.tier, n_groups=n_groups)

            # decode ntok tokens for the running batch; each fused
            # iteration carries piggybacked chunk FLOPs up to its own
            # memory-bound window in its roofline max (one launch, one
            # weight pass per iteration) — leftovers beyond every window
            # pay linear prefill time after the loop
            n_decode_iters = 0
            for _ in range(ntok):
                live = [r for r in running
                        if r.prefilled and r.generated < r.gen_len]
                if not live:
                    break
                n_decode_iters += 1
                ctx = sum(r.prompt_len + r.generated for r in live) / len(live)
                take = min(piggyback_tokens,
                           self.model.piggyback_tokens(
                               self.hw, len(live), ctx, self.weight_bytes))
                dt = self.model.fused_step_time(
                    self.hw, len(live), ctx, self.weight_bytes, take)
                piggyback_tokens -= take
                compute_time += dt
                step_time += dt
                for r in live:
                    r.generated += 1
                    if r.ttft is None:
                        r.ttft = t + step_time
            if piggyback_tokens > 0:
                # chunk FLOPs no decode window absorbed (decode drained
                # early, or grants exceeded the round's windows)
                dt = self.model.prefill_time(self.hw, piggyback_tokens)
                piggyback_tokens = 0
                compute_time += dt
                step_time += dt
            # launch-count model: fused = one jitted call per engine step
            # (chunks ride the decode iterations); per-request baseline adds
            # one call per granted chunk — O(admitted requests) per round
            if self.fused_step:
                n_calls = max(n_decode_iters,
                              1 if (n_chunk_calls or n_decode_iters) else 0)
            else:
                n_calls = n_chunk_calls + n_decode_iters
            step_time += self.model.launch_time(self.hw, n_calls)
            if pagein_time:
                # prefetched page-ins: transfer hidden up to the compute time
                step_time += overlapped_transfer_time(compute_time,
                                                      pagein_time)
            t += step_time

            # retire finished
            for r in list(running):
                if r.generated >= r.gen_len:
                    r.finish = t
                    r.resident = False
                    running.remove(r)
                    done.append(r)
                    if self.admission is not None:
                        self.admission.forget(r.rid)
            timeline.append({"t": t, "running": len(running),
                             "waiting": len(waiting),
                             "deferred": len(deferred),
                             "kv_used": used_bytes(),
                             "occ_frac": (used_bytes() / self.kv_cap
                                          if self.kv_cap > 0 else 0.0)})
        return SimResult(requests, timeline)

    # ------------------------------------------------------------------
    def _switch_time(self, r: Request, direction: str,
                     shared_pinned: bool = False) -> float:
        # resident context only: a mid-prefill request moves just the chunked
        # prefix it has written so far (prefill_pos == prompt_len once done)
        # plus its fixed state pages (SSM/hybrid recurrent leaves).
        # shared_pinned: the request's shared prefix pages stay put (another
        # group member keeps them resident, or they already moved this
        # round) — only the exclusive context flips tiers.
        ctx = (r.prefill_pos if not r.prefilled else r.prompt_len) + r.generated
        shared = (min(r.shared_prefix_len, ctx)
                  if shared_pinned and self.prefix_sharing_ok else 0.0)
        kv = self.model.unique_context_bytes(ctx, shared)
        if self.paging == "paged" and self.coalesced:
            # page-native runtime: tier flip of the page payload. With
            # cross-plane coalescing every plane of the request rides ONE
            # message per (tier, donor); uncoalesced, a hybrid/SSM flip
            # pays one message per plane (ModelCost.n_planes)
            n_groups = 1 if self.coalesce_planes else self.model.n_planes
            spill = self._host_spill if self.tier == "fabric" else 0.0
            base = page_flip_time(self.hw, kv * (1.0 - spill),
                                  tier=self.tier, n_groups=n_groups)
            if spill > 0.0:
                # lease-shrunk donor fleet: the reclaimed slots' share of
                # the flip degrades to the PCIe host link
                base += page_flip_time(self.hw, kv * spill, tier="host",
                                       n_groups=n_groups)
        else:
            # uncoalesced: one message per layer-page fragment (Fig. 3a pain)
            n_frag = (1 if self.coalesced
                      else max(1, int(kv // (2 * 16 * 128 * 64))))
            base = context_switch_time(self.hw, kv, tier=self.tier,
                                       coalesced=self.coalesced,
                                       n_fragments=n_frag)
        return base + self._retry_time(base)

    def _retry_time(self, leg_time: float) -> float:
        """Transient transfer-leg faults under the injector: each failed
        attempt re-pays the leg plus exponential backoff, bounded by the
        injector's retry cap (its consecutive-failure cap guarantees the
        bound is reachable)."""
        if self.faults is None:
            return 0.0
        extra, attempt = 0.0, 0
        while (attempt < self.faults.max_leg_retries
               and self.faults.leg_fails(self.tier, None)):
            attempt += 1
            self.leg_retries += 1
            extra += leg_time + retry_backoff_time(self.hw, attempt)
        return extra

    def _lora_load_time(self, r: Request) -> float:
        """Paper setup: N adapters, random per request, LRU cache holding
        `lora_cache_bytes` of them -> hit probability = resident fraction."""
        if r.lora_bytes <= 0:
            return 0.0
        resident = self.lora_cache / max(r.lora_bytes, 1.0)
        hit_p = min(resident / max(self.lora_num_adapters, 1), 1.0)
        h = (r.rid * 2654435761) % (1 << 32) / float(1 << 32)  # deterministic
        if h < hit_p:
            return 0.0
        link = self.hw.fabric if self.tier == "fabric" else self.hw.host_link
        # vLLM's default path issues one transfer per layer-tensor; the AQUA
        # integration copies the adapter "as is" in one message (paper §B.1)
        msgs = 1 if (self.coalesced and self.tier == "fabric") else 8 * 48
        return link.time(r.lora_bytes, n_messages=msgs)


# ---------------------------------------------------------------------------
# Long-prompt streaming decode (paper Fig. 7 / FlexGen comparison)
# ---------------------------------------------------------------------------
def long_prompt_tokens_per_s(hw: HardwareProfile, model: ModelCost, *,
                             ctx_tokens: int, free_hbm_bytes: float,
                             weight_bytes: float, tier: str) -> float:
    """Decode throughput when the context exceeds free HBM.

    FlexGen's cache policy is all-or-nothing for a given layer: when the
    context does not fit, the whole KV cache is pinned off-device and streams
    through the link every decode step (paper §6.1). AQUA keeps the same
    policy but the cache lives in a donor GPU's HBM, so the stream runs at
    fabric (NVLink/ICI) bandwidth — that bandwidth ratio is the paper's 6x
    (Fig. 7).
    """
    kv_total = model.kv_bytes(ctx_tokens)
    offloaded = kv_total > free_hbm_bytes
    link = hw.fabric if tier == "fabric" else hw.host_link
    t_stream = link.time(kv_total) if offloaded else 0.0
    # attention reads stream from the link; weights still read from HBM
    t_comp = model.decode_step_time(hw, 1, 0 if offloaded else ctx_tokens,
                                    weight_bytes)
    return 1.0 / (t_stream + t_comp)
