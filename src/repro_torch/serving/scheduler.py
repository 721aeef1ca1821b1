"""Prompt schedulers: FCFS continuous batching (vLLM-style) and the
completely fair scheduler (paper §5) — shared by the real engine and the
discrete-event simulator.

Capacity planning is in PAGES, not slots: when constructed with a
``page_cost`` callback (pages a request needs LOCAL if scheduled) and a
``page_budget`` (the LOCAL pool sizes), the run set is chosen so its pages
fit the local tier — the block-table analogue of vLLM's KV-memory admission
gate. Cost and budget are PER-PLANE vectors (np arrays, one entry per page
plane of the unified state runtime: kv / mla token pages, ssm / conv / wkv /
shift state pages); a request fits only when EVERY plane fits. Scalars keep
working for single-plane callers. Without cost/budget the plan degrades to
slot counting.

Budgets are PHYSICAL pages: a ``page_cost`` callback may accept a second
argument — the run set chosen so far — and return the request's MARGINAL
cost given it (the engine discounts pages shared copy-on-write with an
already-chosen request), so two requests aliasing a prompt prefix cost the
prefix once and shared prefixes directly raise admission capacity.

Step execution is budgeted in TOKENS (``split_step_budget``): every step
spends at most ``step_tokens`` tokens, split between the decode lanes (one
each) and prompt-prefill CHUNKS of the run set's not-yet-prefilled requests.
A long prompt therefore never monopolizes a step — its prefill is spread
over several bounded steps while short prompts' chunks and everyone's decode
tokens ride along (chunked continuous batching, Kossmann et al. 2024).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclass
class ReqState:
    rid: int
    arrival: float
    prompt_tokens: List[int]
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None            # batch slot when running
    parked: object = None                 # truthy while paged out
    prefill_pos: int = 0                  # prompt POSITIONS whose state is written
    n_prefix: int = 0                     # VLM prefix-embedding positions
    prefix_embeds: object = None          # (1, n_prefix, d) array when VLM
    shared_tokens: int = 0                # prompt prefix adopted from the
    #                                       prefix index (CoW page sharing)
    ttft_step: Optional[int] = None
    finish_step: Optional[int] = None
    lora_id: Optional[int] = None
    deadline_s: Optional[float] = None    # e2e deadline, seconds after arrival
    ttft_deadline_s: Optional[float] = None  # first-token deadline, same base
    terminal: Optional[str] = None        # set ONLY by the engine's _retire:
    #                                       "finished" | "cancelled" | "expired"
    cancel_reason: Optional[str] = None   # "client" | "deadline" | "fault" | ...

    @property
    def lifecycle(self) -> str:
        """Derived lifecycle state — never stored, so it cannot drift from
        the fields that define it: ``waiting`` → ``prefilling`` → ``running``
        → one of the terminal states stamped by the engine's ``_retire``
        (``finished`` / ``cancelled`` / ``expired``)."""
        if self.terminal is not None:
            return self.terminal
        if self.done:
            return "finished"
        if self.prefilled:
            return "running"
        if self.prefill_pos > 0 or self.slot is not None:
            return "prefilling"
        return "waiting"

    @property
    def prompt_positions(self) -> int:
        """Positions the prompt occupies: VLM prefix embeds + text tokens."""
        return self.n_prefix + len(self.prompt_tokens)

    @property
    def prefilled(self) -> bool:
        return self.prefill_pos >= self.prompt_positions

    @property
    def vruntime(self) -> int:            # CFS: service received = tokens out
        return len(self.generated)

    @property
    def ctx_len(self) -> int:
        return self.prompt_positions + len(self.generated)

    @property
    def resident_tokens(self) -> int:
        """Tokens whose K/V is materialized in the cache right now: prefilled
        prompt tokens plus every generated token but the newest (its K/V is
        appended at the next decode step)."""
        return self.prefill_pos + max(len(self.generated) - 1, 0)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclass
class Decision:
    """One step's plan: ``run`` is the set that should be resident, ``admit``
    the subset of it still needing prefill, ``preempt`` the currently-
    resident requests to page out (always empty for FCFS)."""
    run: List[ReqState]                   # the set that should be resident
    admit: List[ReqState]                 # subset of run needing prefill
    preempt: List[ReqState]               # currently-resident to page out


def split_step_budget(step_tokens: Optional[int], decode_lanes: int,
                      prefill_remaining: Sequence[int], *,
                      flops_slack: Optional[int] = None) -> List[int]:
    """Split one step's token budget into prefill chunk sizes.

    ``decode_lanes`` tokens are reserved for the resident decoding requests
    (one each); the remainder is FAIR-SHARED among the pending prefills so a
    short prompt's chunk rides the same step as a long prompt's — the long
    prefill can no longer monopolize a step (that is the TTFT-under-burst
    fix). Shares that a short prompt cannot use spill over to the others.
    ``step_tokens=None`` disables budgeting: every pending prefill gets its
    full remaining prompt in one chunk (the unchunked baseline).
    Returns one chunk size (possibly 0) per entry of ``prefill_remaining``.

    ``flops_slack`` (``ModelCost.piggyback_tokens``) additionally caps the
    chunk budget at the decode launch's memory-bound FLOPs slack: a mixed
    step is priced at ``max(t_flops, t_mem)``, so chunk tokens inside the
    window ride the decode launch's weight/KV stream FOR FREE while every
    token beyond it extends the step linearly — the roofline-aware sizing
    keeps mixed steps exactly AT the crossover instead of past it.

    When the decode lanes alone consume the whole budget (or the FLOPs
    window is empty), one token is still granted (progress floor): an
    admitted prefill holding a batch slot must never starve behind a
    saturated decode batch, so a step may exceed the budget by at most one
    token.
    """
    rem = [max(r, 0) for r in prefill_remaining]
    if step_tokens is None:
        return rem
    left = max(step_tokens - decode_lanes, 1 if any(rem) else 0)
    if flops_slack is not None:
        left = max(min(left, int(flops_slack)), 1 if any(rem) else 0)
    chunks = [0] * len(rem)
    while left > 0:
        active = [i for i in range(len(rem)) if chunks[i] < rem[i]]
        if not active:
            break
        share = max(left // len(active), 1)
        for i in active:
            take = min(share, rem[i] - chunks[i], left)
            chunks[i] += take
            left -= take
            if left == 0:
                break
    return chunks


def bucket_tokens(n: int, *, lo: int = 8) -> int:
    """Pad a chunk length up to its shape bucket (powers of two from ``lo``),
    so the jit cache holds one trace per bucket instead of one per distinct
    prompt/chunk length."""
    b = lo
    while b < n:
        b *= 2
    return b


def _cost_takes_chosen(page_cost) -> bool:
    """True when a ``page_cost`` callback accepts ``(request, chosen)`` —
    the marginal-cost form that lets the caller discount pages shared with
    the run set picked so far. Single-argument callbacks keep working."""
    if page_cost is None:
        return False
    try:
        params = [p for p in inspect.signature(page_cost).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                                p.VAR_POSITIONAL)]
    except (TypeError, ValueError):      # builtins / odd callables
        return False
    return (any(p.kind == p.VAR_POSITIONAL for p in params)
            or len(params) >= 2)


class FCFSScheduler:
    """vLLM-like: admit in arrival order while slots (and, when page-aware,
    the LOCAL page budget) allow; never preempt. Under memory pressure,
    later arrivals starve (paper Fig. 1a)."""

    def __init__(self, max_running: int, *,
                 page_cost: Optional[Callable[[ReqState], int]] = None,
                 page_budget: Optional[int] = None):
        """Args:
            max_running: batch-slot cap on the run set.
            page_cost: pages a request needs LOCAL if scheduled — scalar or
                per-plane vector; may take ``(request, chosen)`` to return
                the marginal cost given the partially-built run set.
            page_budget: LOCAL pool size(s) the run set must fit.
        """
        self.max_running = max_running
        self.page_cost = page_cost
        self.page_budget = page_budget
        self._marginal = _cost_takes_chosen(page_cost)

    def _cost(self, r: ReqState, chosen: Sequence[ReqState]):
        return (self.page_cost(r, chosen) if self._marginal
                else self.page_cost(r))

    def update_budget(self, page_budget) -> None:
        """Re-plan admission against a new LOCAL/physical budget — the
        engine calls this after a lease shrink or donor loss contracts the
        tiers the run set's pages can live in."""
        self.page_budget = page_budget

    def plan(self, step: int, waiting: Sequence[ReqState],
             running: Sequence[ReqState]) -> Decision:
        """Plan one step: keep everything running, admit waiters in arrival
        order while the slot cap and the PHYSICAL page budget hold (shared
        prefix pages are counted once across the run set via the marginal
        ``page_cost``). Never preempts. Returns a :class:`Decision`."""
        run = list(running)
        pages = 0
        if self.page_cost is not None:
            chosen: List[ReqState] = []
            for r in run:
                pages = pages + self._cost(r, chosen)
                chosen.append(r)
        admit = []
        for r in sorted(waiting, key=lambda r: (r.arrival, r.rid)):
            if len(run) >= self.max_running:
                break
            if self.page_cost is not None and self.page_budget is not None:
                c = self._cost(r, run)
                if run and np.any(pages + c > self.page_budget):
                    break                     # strict FCFS: no skip-ahead
                pages = pages + c
            run.append(r)
            admit.append(r)
        return Decision(run, admit, [])

    def peek(self, step: int, waiting: Sequence[ReqState],
             running: Sequence[ReqState]) -> Decision:
        """Non-binding preview of the next plan (FCFS planning is stateless),
        used by the engine to prefetch page restores during the current step."""
        return self.plan(step, waiting, running)


class CFSScheduler:
    """Completely fair scheduler: every `slice_tokens` generated tokens, the
    requests with the LEAST service run next (paper §5) — as many as fit the
    slot cap and, when page-aware, the LOCAL page budget."""

    def __init__(self, max_running: int, slice_tokens: int = 5, *,
                 page_cost: Optional[Callable[[ReqState], int]] = None,
                 page_budget: Optional[int] = None,
                 prefix_group: Optional[Callable[[ReqState], object]] = None):
        """Args:
            max_running: batch-slot cap on the run set.
            slice_tokens: tokens each resident request decodes between
                fair-pick boundaries.
            page_cost / page_budget: as in :class:`FCFSScheduler` —
                ``page_cost`` may take ``(request, chosen)`` for marginal
                (shared-prefix-discounted) physical-page costing.
            prefix_group: co-scheduling key — requests sharing a radix
                prefix return the same (hashable) group. At a fair-pick
                boundary, same-group requests WITHIN a vruntime class are
                clustered behind the group's earliest member, so sharers
                are admitted by the same plan and their shared prefix
                parks/restores once per plan instead of thrashing between
                interleaved singletons. Clustering never crosses vruntime
                classes — fairness order is untouched.
        """
        self.max_running = max_running
        self.slice_tokens = slice_tokens
        self.page_cost = page_cost
        self.page_budget = page_budget
        self.prefix_group = prefix_group
        self._marginal = _cost_takes_chosen(page_cost)
        self._since_switch = 0

    def _cost(self, r: ReqState, chosen: Sequence[ReqState]):
        return (self.page_cost(r, chosen) if self._marginal
                else self.page_cost(r))

    def _pick_key(self, everyone: Sequence[ReqState]):
        """Fair-pick sort key. Without a ``prefix_group`` callback this is
        (vruntime, arrival, rid). With one, requests sharing a group sort
        behind the group's earliest (arrival, rid) member WITHIN their
        vruntime class — the greedy budget walk then meets sharers
        adjacently and admits them in one plan, so their common prefix
        flips tiers once per plan."""
        if self.prefix_group is None:
            return lambda r: (r.vruntime, r.arrival, r.rid)
        anchor: dict = {}
        for r in everyone:
            g = self.prefix_group(r)
            if g is None:
                continue
            k, me = (r.vruntime, g), (r.arrival, r.rid)
            if k not in anchor or me < anchor[k]:
                anchor[k] = me

        def key(r: ReqState):
            g = self.prefix_group(r)
            a = (anchor[(r.vruntime, g)] if g is not None
                 else (r.arrival, r.rid))
            return (r.vruntime, a, r.arrival, r.rid)
        return key

    def update_budget(self, page_budget) -> None:
        """Re-plan fair picks against a new LOCAL/physical budget (see
        :meth:`FCFSScheduler.update_budget`)."""
        self.page_budget = page_budget

    def plan(self, step: int, waiting: Sequence[ReqState],
             running: Sequence[ReqState]) -> Decision:
        """Plan one step. Off a slice boundary the current run set stands;
        on one, the least-served requests that fit the slot cap and the
        PHYSICAL page budget run next (a request whose pages alias an
        already-picked sharer's prefix pays only its exclusive pages, so
        shared prefixes admit strictly larger fair sets; with a
        ``prefix_group`` key, equal-vruntime sharers are clustered so one
        plan admits them together). Requests falling out of the set are
        returned in ``Decision.preempt``."""
        self._since_switch += 1
        boundary = (self._since_switch >= self.slice_tokens) or not running
        if not boundary:
            return Decision(list(running), [], [])
        self._since_switch = 0
        everyone = list(waiting) + list(running)
        everyone.sort(key=self._pick_key(everyone))
        if self.page_cost is None or self.page_budget is None:
            run = everyone[: self.max_running]
        else:
            run, pages = [], 0
            for r in everyone:
                if len(run) >= self.max_running:
                    break
                c = self._cost(r, run)
                if run and np.any(pages + c > self.page_budget):
                    continue                  # fair-pick the next that fits
                run.append(r)
                pages = pages + c
        run_ids = {r.rid for r in run}
        preempt = [r for r in running if r.rid not in run_ids]
        admit = [r for r in run if r.slot is None and not r.prefilled]
        return Decision(run, admit, preempt)

    def peek(self, step: int, waiting: Sequence[ReqState],
             running: Sequence[ReqState]) -> Decision:
        """Non-binding preview of the next plan: same decision the next
        ``plan`` call will make, with the slice counter restored — the engine
        uses it to issue restore prefetches that overlap this step's compute."""
        saved = self._since_switch
        try:
            return self.plan(step, waiting, running)
        finally:
            self._since_switch = saved


def fairness_spread(requests: Sequence[ReqState]) -> int:
    """Max-min service spread across unfinished requests — including the
    never-admitted (a starved request sits at vruntime 0, which is the
    unfairness FCFS exhibits). CFS bounds this by ~slice_tokens x rotation;
    FCFS lets it grow to the full generation length (paper Fig. 1a)."""
    live = [r for r in requests if not r.done]
    if len(live) < 2:
        return 0
    v = [r.vruntime for r in live]
    return max(v) - min(v)
