"""AQUA-LIB control loops / informers (paper §3, §B), the reference's
``repro/core/control_loop.py`` kept as the port's own copy.

The northbound interface between a serving engine and AQUA-LIB is
``inform_stats(...)``: the engine reports workload characteristics every few
iterations, and the return value tells the engine how much memory it may
reclaim for itself (positive) or should donate (negative).

  * ``LLMInformer``   — an LLM is a producer only while its traffic is low
                        (paper §B "llm-informer"): donates everything except a
                        small responsiveness reserve, reclaims on queue
                        build-up.
  * ``BatchInformer`` — compute-bound image/audio engines run at a fixed
                        peak-throughput batch size; everything beyond that
                        working set is donated ("<10 lines of code" in the
                        paper; about that many here).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque

from repro_torch.core.coordinator import Coordinator


@dataclass
class InformerDecision:
    delta_bytes: float       # >0: engine may grow its cache; <0: donate -delta
    donate: bool
    reclaim: bool


class LLMInformer:
    def __init__(self, name: str, coordinator: Coordinator, *,
                 total_bytes: float, reserve_bytes: float = 5e9,
                 low_rate: float = 2.0, high_rate: float = 4.0,
                 window: int = 8):
        self.name = name
        self.coord = coordinator
        self.total = total_bytes
        self.reserve = reserve_bytes
        self.low, self.high = low_rate, high_rate
        self._pending: Deque[float] = deque(maxlen=window)
        self.donated = 0.0

    def inform_stats(self, pending_requests: int, kv_utilization: float,
                     dt: float = 1.0) -> InformerDecision:
        self._pending.append(pending_requests / max(dt, 1e-9))
        rate = sum(self._pending) / len(self._pending)
        if rate <= self.low and self.donated == 0.0 and kv_utilization < 0.5:
            amount = self.total - self.reserve
            self.coord.offer(self.name, amount)
            self.donated = amount
            return InformerDecision(-amount, donate=True, reclaim=False)
        if rate >= self.high and self.donated > 0.0:
            self.coord.request_reclaim(self.name)
            if self.coord.reclaim_status(self.name):
                got = self.donated
                self.donated = 0.0
                self.coord.withdraw(self.name)
                return InformerDecision(+got, donate=False, reclaim=True)
            return InformerDecision(0.0, donate=False, reclaim=True)
        return InformerDecision(0.0, donate=False, reclaim=False)


class BatchInformer:
    """Producer informer for compute-bound engines (image/audio)."""

    def __init__(self, name: str, coordinator: Coordinator, *,
                 total_bytes: float, working_set_bytes: float):
        self.name = name
        self.coord = coordinator
        self.free = total_bytes - working_set_bytes

    def inform_stats(self, *_args, **_kw) -> InformerDecision:
        if self.free > 0:
            self.coord.offer(self.name, self.free)
            donated, self.free = self.free, 0.0
            return InformerDecision(-donated, donate=True, reclaim=False)
        return InformerDecision(0.0, donate=False, reclaim=False)
