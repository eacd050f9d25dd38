"""Per-request span tracing over an injectable monotonic clock (a copy of
:mod:`repro.obs.trace`).

The tracer records the serving engine's request lifecycle as a flat
chain of **phase spans** per request —

    queued -> prefill -> decode -> {preempt -> backoff -> queued ->
    prefill -> decode}* -> terminal(finish_reason)

— plus **instant events**: per-request marks (``preempt``, exactly one
``terminal:<finish_reason>``) and engine-track tick events (degradation-
ladder transitions, deadline preemptions, FaultPlan injections,
allocator audits, straggler flags).  A phase span opens when the request
enters the phase and closes when the next phase (or the terminal event)
begins, so per-request spans are contiguous and non-overlapping by
construction — the well-formedness the chaos trace test asserts.

Clock: injectable and monotonic-by-contract.  The engine adopts its own
clock into an unset tracer (``clock=None``), so the virtual ``FakeClock``
the resilience tests drive produces deterministic traces, and a replay of
the same seeded chaos run yields byte-identical exports.

Export is Chrome/Perfetto trace-event JSON (the ``traceEvents`` array
format): phase spans become ``"X"`` complete events with microsecond
``ts``/``dur`` relative to the first event, instants become ``"i"``
events, and ``"M"`` metadata events name one thread track per request
(``req <rid>``) plus one per engine-side track — open
``chrome://tracing`` / https://ui.perfetto.dev and load the file.

A module-level **global tracer hook** (:func:`set_global_tracer` /
:func:`instant_global`) lets deep layers that must not depend on the
engine — the block allocator's ``audit()``, the training straggler
monitor, autotune sweep completions — emit events when a tracer is
installed and cost one ``is None`` check when not.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Span", "Instant", "SpanTracer", "set_global_tracer",
           "instant_global"]


@dataclasses.dataclass
class Span:
    """One closed lifecycle phase: [t0, t1) on a request's track."""
    track: str
    name: str
    t0: float
    t1: float
    args: Dict[str, Any]


@dataclasses.dataclass
class Instant:
    """A point event on a request or engine track."""
    track: str
    name: str
    t: float
    args: Dict[str, Any]


class SpanTracer:
    """Collects spans/instants; exports Chrome trace-event JSON.

    Not thread-safe (the engine tick loop is single-threaded); event
    order is the emission order, so identical runs yield identical
    traces.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        #: left None, the first engine this tracer is attached to adopts
        #: its own clock (virtual or wall) — see Engine.__init__
        self.clock = clock
        self.spans: List[Span] = []
        self.instants: List[Instant] = []
        # rid -> (phase_name, t0, args) for the currently-open phase
        self._open: Dict[int, Tuple[str, float, Dict[str, Any]]] = {}
        self._order: List[str] = []     # track names in first-seen order

    # -- emission --------------------------------------------------------

    def _now(self) -> float:
        return (self.clock or time.monotonic)()

    def _track(self, name: str) -> str:
        if name not in self._order:
            self._order.append(name)
        return name

    def req_phase(self, rid: int, phase: str, **args) -> None:
        """Enter ``phase`` on request ``rid``'s track, closing the
        previously open phase at the same timestamp (contiguous spans)."""
        now = self._now()
        self._close(rid, now)
        self._open[rid] = (phase, now, args)
        self._track(f"req {rid}")

    def req_instant(self, rid: int, name: str, **args) -> None:
        self.instants.append(Instant(self._track(f"req {rid}"), name,
                                     self._now(), args))

    def req_terminal(self, rid: int, finish_reason: str, **args) -> None:
        """Close the request's open phase and emit its single terminal
        instant ``terminal:<finish_reason>``."""
        now = self._now()
        self._close(rid, now)
        self.instants.append(Instant(
            self._track(f"req {rid}"), f"terminal:{finish_reason}", now,
            dict(args, finish_reason=finish_reason)))

    def instant(self, track: str, name: str, **args) -> None:
        """Engine-side point event (ladder move, fault injection, ...)."""
        self.instants.append(Instant(self._track(track), name, self._now(),
                                     args))

    def _close(self, rid: int, now: float) -> None:
        open_ = self._open.pop(rid, None)
        if open_ is not None:
            phase, t0, args = open_
            self.spans.append(Span(f"req {rid}", phase, t0, now, args))

    def close_all(self) -> None:
        """Close any still-open phases at the current clock (requests
        left non-terminal when the run stopped)."""
        now = self._now()
        for rid in list(self._open):
            self._close(rid, now)

    # -- queries (test/debug surface) ------------------------------------

    def spans_for(self, rid: int) -> List[Span]:
        track = f"req {rid}"
        return [s for s in self.spans if s.track == track]

    def terminals_for(self, rid: int) -> List[Instant]:
        track = f"req {rid}"
        return [i for i in self.instants
                if i.track == track and i.name.startswith("terminal:")]

    # -- Chrome trace export ---------------------------------------------

    def chrome_trace(self) -> dict:
        """The trace as a Chrome trace-event JSON object.

        ``ts`` is microseconds relative to the earliest event, so virtual
        clocks starting at 0.0 and wall clocks both render sensibly.
        Still-open phases are closed at the current clock first.
        """
        self.close_all()
        events = []
        times = ([s.t0 for s in self.spans]
                 + [i.t for i in self.instants])
        base = min(times) if times else 0.0
        tids = {name: i + 1 for i, name in enumerate(self._order)}
        for name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "args": {"name": name}})
        us = 1e6
        for s in self.spans:
            events.append({
                "ph": "X", "name": s.name, "pid": 1,
                "tid": tids[s.track],
                "ts": (s.t0 - base) * us,
                "dur": max((s.t1 - s.t0) * us, 0.0),
                "args": s.args,
            })
        for i in self.instants:
            events.append({
                "ph": "i", "s": "t", "name": i.name, "pid": 1,
                "tid": tids[i.track],
                "ts": (i.t - base) * us,
                "args": i.args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)


#: process-global tracer hook for layers that must not import the engine
#: (allocator audits, straggler flags, autotune sweeps).  None (default)
#: means every instant_global call is one comparison and a return.
_GLOBAL: Optional[SpanTracer] = None


def set_global_tracer(tracer: Optional[SpanTracer]) -> None:
    global _GLOBAL
    _GLOBAL = tracer


def instant_global(track: str, name: str, **args) -> None:
    if _GLOBAL is not None:
        _GLOBAL.instant(track, name, **args)
