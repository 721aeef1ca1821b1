"""SLO-aware admission control — the port's copy of
``repro/serving/admission.py`` (numpy only): keep the serving system inside
its page-occupancy stability region under bursty arrivals.

The schedulers budget the RUN SET against the LOCAL page pools, which
bounds instantaneous occupancy but not its trajectory: a request priced at
its prompt grows by one token per decode step until it completes, so under
a burst the in-flight set's committed future occupancy overshoots capacity
and every later step pays page churn. :class:`AdmissionController` prices
each candidate at its marginal per-plane page cost now and at completion,
projects the committed set's piecewise-linear occupancy trajectory, and
admits the candidate only while that trajectory's peak stays below
``headroom`` x budget. Everything else is DEFERRED (degrade-to-queue,
never reject): the admit path never raises, and configuration errors raise
only the typed ``AdmissionError``.

While decode lanes are live, at most ``prefill_admit_limit`` requests may
be in their prefill phase at once. Budgets are read through a callable
each step, so the engine's ``_replan_capacity`` (lease shrink, donor loss)
contracts the region with no extra wiring.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.errors import AdmissionError


class AdmissionController:
    """Stability-region admission over caller-supplied cost callables.

    Args:
        budget: zero-arg callable returning the per-plane page budget (or a
            1-vector of bytes on the analytic clock). Re-read every
            ``filter`` call so lease shrinks / donor losses contract the
            stability region automatically.
        current_cost: ``(request, chosen) -> vector`` — the request's
            occupancy RIGHT NOW, marginal against the committed set chosen
            so far (shared prefix pages/bytes counted once).
        terminal_cost: ``(request, chosen) -> vector`` — occupancy at
            COMPLETION (context grown to prompt + max_new tokens), same
            marginal convention. This is what naive current-cost admission
            ignores and what the trajectory grows toward.
        remaining_tokens: ``request -> (prefill_remaining, decode_remaining)``
            in tokens — sets the projection's time base.
        headroom: fraction of the budget the projected trajectory may fill
            (the remainder absorbs projection error: CoW clones, page
            rounding, chunk-rate variance). Must be in (0, 1].
        step_tokens: the engine/simulator step token budget — prefill
            advances at roughly this rate fair-shared across live prefills;
            ``None`` means whole-prompt prefill (one step).
        prefill_admit_limit: max requests simultaneously in their prefill
            phase while any committed request is decoding (``None`` = no
            mixing cap).
        slo_ttft_s / step_time: optional SLO observability — with both
            given, each admission's projected prefill-completion time is
            checked against the TTFT SLO and ``slo_at_risk`` counts the
            admissions projected to miss it (observational only: the
            response to overload is deferral, which the stability check
            already does).
        horizon: projection length cap in steps. Internally the trajectory
            is discretized into a fixed number of bins spanning the
            horizon (peaks are checked per bin, ramps rounded UP a bin —
            conservative), so ``filter``'s cost is independent of horizon.
        order_key: candidate-ordering key. Default is arrival order
            ``(arrival, rid)``; the engine passes an earliest-deadline-first
            key so deadline-carrying requests are priced (and admitted)
            before slack ones — urgency, not just age, decides who enters
            the region first.
        deadline_of: ``request -> Optional[seconds]`` — the request's
            REMAINING end-to-end deadline slack (``None`` = no deadline).
            With ``step_time`` also given, a candidate whose projected
            finish lies past its remaining slack is DOOMED — it would hold
            pages only to be shed at expiry — so it is deferred and, more
            importantly, EXCLUDED from the projected-occupancy trajectory:
            work that will miss anyway must not shrink the region for work
            that can still make it. The engine's deadline sweep reclaims
            the doomed request once its clock actually runs out.

    Raises:
        AdmissionError: invalid configuration (bad headroom/horizon). The
            admit/defer path itself never raises.
    """

    def __init__(self, *, budget: Callable[[], np.ndarray],
                 current_cost: Callable, terminal_cost: Callable,
                 remaining_tokens: Callable,
                 headroom: float = 0.9,
                 step_tokens: Optional[int] = None,
                 prefill_admit_limit: Optional[int] = 4,
                 slo_ttft_s: Optional[float] = None,
                 step_time: Optional[Callable[[], float]] = None,
                 horizon: int = 4096,
                 order_key: Optional[Callable] = None,
                 deadline_of: Optional[Callable] = None):
        if not 0.0 < headroom <= 1.0:
            raise AdmissionError(f"headroom={headroom} not in (0, 1]")
        if horizon < 1:
            raise AdmissionError(f"horizon={horizon} must be >= 1")
        if prefill_admit_limit is not None and prefill_admit_limit < 1:
            raise AdmissionError("prefill_admit_limit must be >= 1 (zero "
                                 "would deadlock a cold system)")
        self._budget = budget
        self._current = current_cost
        self._terminal = terminal_cost
        self._remaining = remaining_tokens
        self.headroom = float(headroom)
        self.step_tokens = step_tokens
        self.prefill_admit_limit = prefill_admit_limit
        self.slo_ttft_s = slo_ttft_s
        self._step_time = step_time
        self._order_key = order_key or (lambda r: (r.arrival, r.rid))
        self._deadline_of = deadline_of
        self.horizon = int(horizon)
        # fixed-resolution projection: `_bins` samples across the horizon
        # keep the per-candidate cost O(bins) no matter how long requests
        # live; each bin covers `_bin_steps` engine steps
        self._bins = min(self.horizon, 192)
        self._bin_steps = max(1, -(-self.horizon // self._bins))
        self._admitted: set = set()
        # observability
        self.admitted_total = 0
        self.deferred_total = 0          # defer decisions (per filter call)
        self.slo_at_risk = 0
        self.deadline_doomed = 0         # deferrals because finish > slack
        self.occupancy_frac = 0.0        # committed t=0 occupancy / budget
        self.projected_peak_frac = 0.0   # committed trajectory peak / budget
        self.decisions: Deque[Dict] = deque(maxlen=4096)

    # ------------------------------------------------------------------
    def _curve(self, r, chosen: Sequence, n_prefill_live: int
               ) -> Tuple[np.ndarray, np.ndarray, int]:
        """(cost_now, cost_terminal, finish_step) for one request.

        The projected occupancy is linear from ``cost_now`` to
        ``cost_terminal`` over its remaining steps (prefill at the
        fair-shared chunk rate, then one decode token per step), dropping
        to zero at ``finish_step`` when completion frees the pages."""
        c_now = np.asarray(self._current(r, chosen), np.float64)
        c_term = np.asarray(self._terminal(r, chosen), np.float64)
        p_rem, d_rem = self._remaining(r)
        p_rem, d_rem = max(int(p_rem), 0), max(int(d_rem), 0)
        if p_rem == 0:
            steps_p = 0
        elif self.step_tokens is None:
            steps_p = 1
        else:
            rate = max(self.step_tokens // max(n_prefill_live, 1), 1)
            steps_p = -(-p_rem // rate)
        return c_now, np.maximum(c_term, c_now), steps_p + d_rem

    def _add_curve(self, traj: np.ndarray, c_now: np.ndarray,
                   c_term: np.ndarray, finish: int) -> np.ndarray:
        """Add one request's piecewise-linear occupancy to the committed
        trajectory ``traj`` (shape ``(_bins, n_planes)``; each bin spans
        ``_bin_steps`` engine steps and holds the request's occupancy at
        the bin's END — the ramp's maximum over the bin, conservative)."""
        B = traj.shape[0]
        k = min(max(-(-finish // self._bin_steps), 1), B)
        ramp = np.linspace(1.0 / k, 1.0, k, endpoint=True)[:, None]
        traj[:k] += c_now[None, :] * (1.0 - ramp) + c_term[None, :] * ramp
        # pages free at completion: nothing added past `finish`. A request
        # whose completion lies past the horizon holds its terminal cost at
        # the horizon's edge (conservative).
        if finish > B * self._bin_steps:
            traj[k:] += c_term[None, :]
        return traj

    # ------------------------------------------------------------------
    def filter(self, waiting: Sequence, running: Sequence
               ) -> Tuple[List, List]:
        """Partition ``waiting`` into (eligible, deferred) for this step.

        Previously admitted requests (including CFS-preempted ones cycling
        through the waiting list) stay eligible unconditionally — admission
        is a one-way gate ahead of the scheduler, it never fights the fair
        pick. New candidates are walked in arrival order and admitted while
        the committed occupancy trajectory (running + already admitted +
        candidate) peaks below ``headroom`` x budget and the prefill-mixing
        cap holds. Later small candidates may be admitted past an earlier
        deferred large one (admission is not FCFS-strict — bounding
        occupancy is the point); the deferred one retries every step and
        admits as completions reopen the region.

        Progress floor: with nothing running and nothing eligible, the
        head-of-line candidate passes through regardless — the scheduler's
        own budget walk decides, so one over-region request on an idle
        system degrades to the scheduler's behavior instead of deadlocking.
        """
        budget = np.asarray(self._budget(), np.float64)
        region = self.headroom * budget
        committed: List = list(running)
        eligible: List = []
        deferred: List = []
        candidates: List = []
        for r in waiting:
            if r.rid in self._admitted:
                committed.append(r)
                eligible.append(r)
            else:
                candidates.append(r)
        n_prefill_live = sum(1 for r in committed
                             if self._remaining(r)[0] > 0)
        any_decode = any(self._remaining(r)[0] == 0 for r in committed)
        traj = np.zeros((self._bins, len(budget)), np.float64)
        chosen: List = []
        for r in committed:
            c_now, c_term, fin = self._curve(r, chosen, n_prefill_live)
            traj = self._add_curve(traj, c_now, c_term, fin)
            chosen.append(r)
        self.occupancy_frac = float(np.max(traj[0] / np.maximum(budget, 1.0)))

        n_prefilling = n_prefill_live
        for r in sorted(candidates, key=self._order_key):
            mix_ok = (self.prefill_admit_limit is None or not any_decode
                      or n_prefilling < self.prefill_admit_limit)
            c_now, c_term, fin = self._curve(r, chosen,
                                             max(n_prefilling, 1))
            # a candidate that cannot finish inside its deadline slack is
            # excluded from the trajectory: admitting it would spend region
            # on work the deadline sweep will shed anyway
            doomed = False
            if self._deadline_of is not None and self._step_time is not None:
                slack = self._deadline_of(r)
                if slack is not None and fin * self._step_time() > slack:
                    doomed = True
                    self.deadline_doomed += 1
            cand = self._add_curve(traj.copy(), c_now, c_term, fin)
            fits = bool(np.all(cand.max(axis=0) <= region))
            admit = fits and mix_ok and not doomed
            self.decisions.append({
                "rid": r.rid, "admitted": admit, "fits": fits,
                "mix_ok": mix_ok, "doomed": doomed, "cost_now": c_now.copy(),
                "occupancy_before": traj[0].copy(), "budget": budget.copy(),
                "projected_peak": cand.max(axis=0).copy()})
            if admit:
                traj = cand
                chosen.append(r)
                eligible.append(r)
                self._admitted.add(r.rid)
                self.admitted_total += 1
                if self._remaining(r)[0] > 0:
                    n_prefilling += 1
                if (self.slo_ttft_s is not None
                        and self._step_time is not None):
                    steps_p = fin - self._remaining(r)[1]
                    if steps_p * self._step_time() > self.slo_ttft_s:
                        self.slo_at_risk += 1
            else:
                deferred.append(r)
                self.deferred_total += 1
        self.projected_peak_frac = float(
            np.max(traj.max(axis=0) / np.maximum(budget, 1.0)))

        if not running and not eligible and deferred:
            # progress floor: an idle system must not deadlock behind a
            # request whose terminal footprint alone exceeds the region
            head = min(deferred, key=self._order_key)
            deferred.remove(head)
            eligible.append(head)
            self._admitted.add(head.rid)
            self.admitted_total += 1
        return eligible, deferred

    # ------------------------------------------------------------------
    def forget(self, rid: int) -> None:
        """Drop a request from the admitted set — called at retirement
        (its pages are free) and on lost-page recovery (the request resets
        to prefill position 0 and must re-price against the contracted
        region before re-entering)."""
        self._admitted.discard(rid)

    @property
    def admitted_rids(self) -> set:
        return set(self._admitted)
