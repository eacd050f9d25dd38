"""Deterministic fault injection for the serving engine (a copy of
:mod:`repro.serving.faults`: the same seed fires the same faults at the
same decision points).

Why: the engine's overload machinery — preempt-and-requeue with recompute,
deadline timeouts, the graceful-degradation ladder, stall/deadlock
breaking — only earns trust if it is *exercised*, and real faults (a dry
page pool mid-burst, a NaN tick from a flaky accelerator, a straggling
host) are rare and unreproducible in CI.  A :class:`FaultPlan` is a
seed-driven schedule of synthetic faults threaded behind a no-op default
into the allocator and the tick loop, so a chaos test can replay the exact
same fault sequence every run and assert the recovery invariants: every
request reaches a terminal state, greedy streams of requests that finish
normally are bit-identical to a fault-free run (recompute heals
preemptions and corrupt ticks), and ``BlockAllocator.audit()`` comes back
leak-free.

Fault surfaces (all off by default — a ``None`` plan costs nothing):

* **allocator returns no page** (``p_alloc_fail``) — ``can_admit`` /
  ``ensure_range`` report a dry pool even when pages are free, forcing
  admission gating, decode stalls, and the all-stalled preempt-requeue
  path.  Injected *before* any page is mapped, so the allocator's own
  invariants hold and ``audit()`` must stay clean through any plan.
* **NaN/inf logits on a chosen tick** (``nan_ticks`` / ``p_nan``) — the
  engine treats the tick's sampled tokens as garbage (the host-side
  validity guard fires) and heals the affected slots by preempt-requeue:
  re-prefill recomputes clean state, so greedy streams are unchanged.
* **simulated slow ticks** (``slow_ticks`` / ``p_slow`` +
  ``slow_extra_s``) — extra seconds added to the tick duration the
  degradation watchdog observes (simulated, not slept: chaos runs stay
  CPU-fast), driving ladder step-downs without real stragglers.
* **spurious stalls** (``p_spurious_stall``) — an active slot is parked
  for the tick as if its next page could not be mapped, exercising the
  stall bookkeeping off the genuinely-dry-pool path.

Determinism: each fault surface draws from its own seeded
``numpy.random.RandomState`` stream (derived from ``seed``), so one
surface's draw count never shifts another's, and two engines running the
same workload against plans built with the same parameters see the same
faults at the same decision points.  ``injected`` counts what actually
fired, for test assertions and the overload bench report.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class FaultPlan:
    """Seed-driven synthetic fault schedule (see module docstring).

    Probabilities are per *decision point*: ``p_alloc_fail`` per allocator
    capacity/mapping call, ``p_spurious_stall`` per (active slot, tick),
    ``p_nan`` / ``p_slow`` per tick.  ``nan_ticks`` / ``slow_ticks`` name
    explicit tick indices on top of the random draws.
    """

    seed: int = 0
    p_alloc_fail: float = 0.0
    p_spurious_stall: float = 0.0
    p_nan: float = 0.0
    nan_ticks: Tuple[int, ...] = ()
    p_slow: float = 0.0
    slow_ticks: Tuple[int, ...] = ()
    slow_extra_s: float = 0.0

    def __post_init__(self):
        # one independent stream per fault surface: a surface's draw count
        # never shifts another surface's sequence, so plans replay exactly
        self._rs_alloc = np.random.RandomState(self.seed)
        self._rs_stall = np.random.RandomState(self.seed + 1)
        self._rs_nan = np.random.RandomState(self.seed + 2)
        self._rs_slow = np.random.RandomState(self.seed + 3)
        self.injected: Dict[str, int] = {
            "alloc_fail": 0, "spurious_stall": 0, "nan": 0, "slow": 0}

    # -- fault surfaces ----------------------------------------------------

    def alloc_fail(self) -> bool:
        """One allocator capacity/mapping decision: deny the page?"""
        if self.p_alloc_fail <= 0.0:
            return False
        hit = bool(self._rs_alloc.rand() < self.p_alloc_fail)
        if hit:
            self.injected["alloc_fail"] += 1
        return hit

    def spurious_stall(self, slot: int) -> bool:
        """Park this active slot for the tick as if its page map failed?"""
        if self.p_spurious_stall <= 0.0:
            return False
        hit = bool(self._rs_stall.rand() < self.p_spurious_stall)
        if hit:
            self.injected["spurious_stall"] += 1
        return hit

    def logits_corrupt(self, tick: int) -> bool:
        """Non-finite logits this tick (sampled tokens are garbage)?"""
        hit = tick in self.nan_ticks
        if not hit and self.p_nan > 0.0:
            hit = bool(self._rs_nan.rand() < self.p_nan)
        if hit:
            self.injected["nan"] += 1
        return hit

    def extra_tick_s(self, tick: int) -> float:
        """Extra seconds the watchdog should see for this tick (simulated
        straggler — nothing actually sleeps)."""
        hit = tick in self.slow_ticks
        if not hit and self.p_slow > 0.0:
            hit = bool(self._rs_slow.rand() < self.p_slow)
        if not hit:
            return 0.0
        self.injected["slow"] += 1
        return self.slow_extra_s
