"""Straggler detection (port of the ``StragglerMonitor`` of
:mod:`repro.dist.elastic`; the mesh-healing policy and the SIGTERM drain
wait for the port of the distributed layer, ROADMAP.md).

The serving engine uses the monitor as its tick-latency watchdog (one of
the pressure signals of the degradation ladder) and the train launcher
over its step times.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

#: every StragglerMonitor flag (training step OR serving tick watchdog)
#: also lands in the process-global obs registry, so exporters see
#: straggler pressure without threading the monitor through them
_FLAGS = obs_metrics.REGISTRY.counter(
    "straggler_flags_total", "StragglerMonitor outlier flags")


class StragglerMonitor:
    """EWMA step-time monitor that flags outliers without absorbing them.

    An observation above ``factor`` x the EWMA is flagged and EXCLUDED from
    the average — a single preemption stall must not raise the baseline
    and mask the next one.  The first ``warmup`` observations always feed
    the EWMA (no baseline exists yet to judge them against).

    A SUSTAINED slowdown is not a straggler: after ``adapt_after``
    consecutive flags the monitor treats the new step time as a level
    shift, re-seeds the baseline from it and stops flagging — otherwise a
    legitimate workload change would freeze the baseline and flag every
    step forever.

    The serving engine calls :meth:`reset` on every degradation-ladder
    transition: the tick cost legitimately changes with the serving
    level, so the old baseline must not flag (or mask) the new one.
    """

    def __init__(self, alpha: float = 0.1, factor: float = 3.0,
                 warmup: int = 3, adapt_after: int = 5):
        self.alpha = alpha
        self.factor = factor
        self.warmup = warmup
        self.adapt_after = adapt_after
        self.ewma: Optional[float] = None
        self.flagged: List[int] = []
        self._count = 0
        self._consecutive = 0

    def reset(self) -> None:
        """Drop the baseline after a legitimate level shift; the next
        observation re-seeds the EWMA.  ``flagged`` history is kept — it
        is an audit log, not part of the baseline."""
        self.ewma = None
        self._count = 0
        self._consecutive = 0

    def observe(self, step: int, dt: float) -> bool:
        """Record one step time; True if ``step`` is a straggler."""
        self._count += 1
        if self.ewma is None:
            self.ewma = float(dt)
            return False
        if self._count > self.warmup and dt > self.factor * self.ewma:
            self._consecutive += 1
            if self._consecutive >= self.adapt_after:
                self.ewma = float(dt)  # level shift, not a straggler
                self._consecutive = 0
                return False
            self.flagged.append(step)
            _FLAGS.inc()
            obs_trace.instant_global("train", "straggler", step=step,
                                     dt_s=float(dt),
                                     ewma_s=float(self.ewma))
            return True
        self._consecutive = 0
        self.ewma = (1.0 - self.alpha) * self.ewma + self.alpha * float(dt)
        return False
