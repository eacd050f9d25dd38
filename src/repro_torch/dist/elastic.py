"""Elastic execution utilities: mesh healing, straggler detection, drain
(port of :mod:`repro.dist.elastic`).

Model-parallel groups are load-bearing (the weights are sharded across
them), so on device loss the policy shrinks DATA parallelism first —
dropping whole replicas — and only degrades the model axis when fewer
than one full model-parallel group survives.  Data-parallel size is kept a
power of two so gradient all-reduce rings stay balanced and the synthetic
data pipeline reshards evenly.

The serving engine uses the straggler monitor as its tick-latency
watchdog (one of the pressure signals of the degradation ladder) and the
train launcher over its step times; the launcher polls the
:class:`Heartbeat` once a step and drains on SIGTERM.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
from typing import List, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

#: every StragglerMonitor flag (training step OR serving tick watchdog)
#: also lands in the process-global obs registry, so exporters see
#: straggler pressure without threading the monitor through them
_FLAGS = obs_metrics.REGISTRY.counter(
    "straggler_flags_total", "StragglerMonitor outlier flags")


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


@dataclasses.dataclass
class ElasticPolicy:
    """Resolve a (data, model) mesh shape from the surviving device count."""

    model_parallel: int = 16

    def resolve_mesh(self, n_devices: int) -> Tuple[int, int]:
        if n_devices < 1:
            raise ValueError("no devices")
        mp = self.model_parallel
        if n_devices >= mp:
            return (_pow2_floor(n_devices // mp), mp)
        # fewer devices than one model-parallel group: degrade the model axis
        return (1, _pow2_floor(n_devices))


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


class Heartbeat:
    """SIGTERM drain flag for the train loop.

    ``install()`` registers handlers and returns self; the loop polls
    ``should_stop`` once per step and checkpoints before exiting (the
    preemption path of :mod:`repro_torch.launch.train`, which agrees the
    flag across ranks).  Registration is skipped outside the main thread
    (signal handlers are main-thread-only in CPython).
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = signals
        self._stop = threading.Event()
        self._previous = {}

    def install(self) -> "Heartbeat":
        try:
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handle)
        except ValueError:
            pass  # not the main thread
        return self

    def uninstall(self):
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._previous = {}

    def _handle(self, signum, frame):
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()
