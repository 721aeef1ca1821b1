"""Bursty serving workloads — the port's copy of ``repro/core/workload.py``
(numpy only), with the ``Request`` record it draws.

The paper's headline claim is responsiveness under bursty request
patterns. These seedable generators produce :class:`Request` streams with
the three properties production LLM traffic has, so the admission
controller (``serving/admission.py``) is exercised against the load that
breaks naive admission:

  * **heavy-tailed lengths** — prompt and output lengths are lognormal;
  * **Poisson-modulated arrival spikes** — a baseline rate, multiplied by
    ``factor`` inside :class:`BurstSpec` windows;
  * **multi-tenant prefix mixes** — tenants own system prompts shared by
    their requests (``prefix_group`` / ``shared_prefix_len``) with
    Zipf-like traffic shares.

Every generator is a pure function of its arguments: the same arguments
give a bit-identical trace (and the reference's trace, draw for draw).
``prompt_tokens_for`` maps a stream onto token ids for
``ServingEngine.submit``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Request:
    """One request of a generated stream: the reference's
    ``repro/core/simulator.py`` record. The port's simulator
    (``core/simulator.py``) imports it from this module, so
    ``simulator.Request`` is this class.

    ``prefix_group`` requests alias the pages of their common
    ``shared_prefix_len``-token prompt prefix. ``deadline_s`` /
    ``ttft_deadline_s`` are end-to-end / first-token deadlines in seconds
    after ``arrival``; the rest is the simulator's progress state."""
    rid: int
    arrival: float
    prompt_len: int
    gen_len: int
    lora_bytes: float = 0.0
    prefix_group: Optional[int] = None
    shared_prefix_len: int = 0
    deadline_s: Optional[float] = None
    ttft_deadline_s: Optional[float] = None
    cancelled: bool = False
    cancel_reason: Optional[str] = None   # "fault" | "deadline"
    generated: int = 0
    prefill_pos: int = 0             # prompt tokens prefilled so far
    prefilled: bool = False
    ttft: Optional[float] = None
    finish: Optional[float] = None
    resident: bool = False           # context currently in local memory
    recovered: bool = False          # recomputed after a donor loss


@dataclass(frozen=True)
class BurstSpec:
    """One arrival-rate spike window on top of the baseline Poisson rate:
    inside ``[start, start + duration)`` the rate is ``base_rate * factor``.
    Overlapping windows modulate (the largest factor wins), never stack."""
    start: float
    duration: float
    factor: float = 10.0


def rate_at(t: float, base_rate: float, bursts: Sequence[BurstSpec]) -> float:
    """Instantaneous arrival rate of the modulated Poisson process at t."""
    f = 1.0
    for b in bursts:
        if b.start <= t < b.start + b.duration:
            f = max(f, b.factor)
    return base_rate * f


def _thinned_arrivals(rng: np.random.Generator, n: int, base_rate: float,
                      bursts: Sequence[BurstSpec]) -> List[float]:
    """First ``n`` arrival times of the modulated Poisson process, by
    thinning at the envelope (max) rate — exact for piecewise-constant
    rates and deterministic for a given rng state."""
    env = base_rate * max([b.factor for b in bursts], default=1.0)
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        t += float(rng.exponential(1.0 / env))
        if rng.random() < rate_at(t, base_rate, bursts) / env:
            out.append(t)
    return out


def make_bursty_requests(n: int, *, seed: int = 0, base_rate: float = 2.0,
                         bursts: Sequence[BurstSpec] = (),
                         prompt_median: float = 384.0,
                         prompt_sigma: float = 0.7,
                         gen_median: float = 256.0,
                         gen_sigma: float = 0.9,
                         max_prompt: int = 8192, max_gen: int = 4096,
                         n_tenants: int = 0,
                         system_prompt: Tuple[int, int] = (256, 1024),
                         lora_bytes: float = 0.0) -> List[Request]:
    """A bursty, heavy-tailed, optionally multi-tenant request stream.

    Args:
        n: number of requests.
        seed: RNG seed; the trace is a pure function of the arguments.
        base_rate: baseline Poisson arrival rate (requests/s).
        bursts: :class:`BurstSpec` spike windows modulating the rate.
        prompt_median / prompt_sigma: lognormal prompt length (median
            tokens, log-space sigma).
        gen_median / gen_sigma: the same for the output length.
        max_prompt / max_gen: hard clamps.
        n_tenants: 0 for single-tenant traffic; otherwise each request
            belongs to a tenant drawn with a 1/rank share and carries the
            tenant's system prompt (log-uniform length in
            ``system_prompt``) as its shared prefix.
        lora_bytes: per-request adapter bytes.

    Returns:
        ``Request`` list sorted by arrival, ``rid`` = arrival order.
    """
    rng = np.random.default_rng(seed)
    arrivals = _thinned_arrivals(rng, n, base_rate, bursts)
    sys_len: List[int] = []
    share = None
    if n_tenants > 0:
        lo, hi = system_prompt
        sys_len = [int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
                   for _ in range(n_tenants)]
        share = np.array([1.0 / (1 + t) for t in range(n_tenants)])
        share /= share.sum()
    reqs: List[Request] = []
    for i, at in enumerate(arrivals):
        p = int(rng.lognormal(np.log(prompt_median), prompt_sigma)) + 1
        g = int(rng.lognormal(np.log(gen_median), gen_sigma)) + 1
        group: Optional[int] = None
        shared = 0
        if n_tenants > 0:
            tenant = int(rng.choice(n_tenants, p=share))
            group, shared = tenant, sys_len[tenant]
            p = shared + min(p, max(max_prompt - shared, 1))
        reqs.append(Request(i, float(at), min(p, max_prompt),
                            min(g, max_gen), lora_bytes=lora_bytes,
                            prefix_group=group, shared_prefix_len=shared))
    return reqs


def make_multi_tenant_requests(n: int, n_tenants: int = 6, seed: int = 0,
                               system_prompt=(1024, 3072),
                               tail_mean: float = 96.0,
                               gen=(40, 120), burst: float = 1.0,
                               think_time: float = 30.0) -> List[Request]:
    """Heavy-tailed multi-tenant stream for the prefix-cache workloads:
    tenants' system prompts (log-uniform in ``system_prompt``) with
    lognormal per-request tails, arriving in tenant bursts separated by
    exponential think time, tenant shares 1/rank. A pure function of the
    arguments; ``rid`` = arrival order."""
    rng = np.random.default_rng(seed)
    lo, hi = system_prompt
    sys_len = [int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
               for _ in range(n_tenants)]
    share = np.array([1.0 / (1 + t) for t in range(n_tenants)])
    share /= share.sum()
    reqs, t, i = [], 0.0, 0
    while i < n:
        tenant = int(rng.choice(n_tenants, p=share))
        t += rng.exponential(think_time)
        k = min(1 + rng.poisson(burst), n - i)
        at = t
        for _ in range(k):
            tail = int(rng.lognormal(np.log(tail_mean), 0.8)) + 1
            reqs.append(Request(
                i, float(at), sys_len[tenant] + tail,
                int(rng.integers(*gen)), prefix_group=tenant,
                shared_prefix_len=sys_len[tenant]))
            at += rng.exponential(1.0)
            i += 1
    reqs.sort(key=lambda r: r.arrival)
    for j, r in enumerate(reqs):
        r.rid = j
    return reqs


def make_cancel_events(requests: Sequence[Request], *, frac: float = 0.2,
                       seed: int = 0, mean_wait_s: float = 5.0) -> List:
    """Seedable client-abandonment schedule: a ``frac`` subset of
    ``requests`` is cancelled ``Exp(mean_wait_s)`` seconds after arrival.
    Returns ``FaultEvent(kind="cancel", rid=..., at_time=...)`` sorted by
    fire time, for the engine's dual-clock fault poll.

    Raises:
        ValueError: ``frac`` is not in [0, 1].
    """
    from repro_torch.core.faults import FaultEvent
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"frac={frac} not in [0, 1]")
    rng = np.random.default_rng((seed, 3))
    events = []
    for r in requests:
        if rng.random() < frac:
            wait = float(rng.exponential(mean_wait_s))
            events.append(FaultEvent(kind="cancel", rid=r.rid,
                                     at_time=r.arrival + wait))
    events.sort(key=lambda ev: ev.at_time)
    return events


def prompt_tokens_for(requests: Sequence[Request], *, vocab: int = 251,
                      seed: int = 0) -> Dict[int, List[int]]:
    """Token ids for a generated stream: requests of one ``prefix_group``
    share the same first ``shared_prefix_len`` ids (so the radix prefix
    index aliases their pages), tails come from a per-rid stream. Token 0
    is avoided. Returns ``{rid: [token ids]}``."""
    prefixes: Dict[object, List[int]] = {}
    out: Dict[int, List[int]] = {}
    for r in requests:
        toks: List[int] = []
        if r.prefix_group is not None and r.shared_prefix_len > 0:
            if r.prefix_group not in prefixes:
                g = np.random.default_rng((seed, 1, int(r.prefix_group)))
                prefixes[r.prefix_group] = (
                    1 + g.integers(0, vocab - 1,
                                   size=r.shared_prefix_len)).tolist()
            toks.extend(prefixes[r.prefix_group][:r.shared_prefix_len])
        tail = r.prompt_len - len(toks)
        if tail > 0:
            g = np.random.default_rng((seed, 2, int(r.rid)))
            toks.extend((1 + g.integers(0, vocab - 1, size=tail)).tolist())
        out[r.rid] = toks[:r.prompt_len]
    return out
