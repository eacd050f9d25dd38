"""A deterministic clock for the engine parity tests.

Both serving engines feed every tick's duration to a straggler watchdog
that steps the degradation ladder down after three slow ticks.  On the
wall clock a loaded machine can slow one engine's ticks and not the
other's, so the two runs would step the ladder at different ticks.  With
a ``StepClock`` per engine a tick lasts a fixed number of steps on every
machine, and the ladder moves only where a test drives it.
"""

from __future__ import annotations


class StepClock:
    """A counter that advances by ``step`` seconds on every read."""

    def __init__(self, step: float = 1e-3):
        self.step = step
        self.t = 0.0

    def __call__(self) -> float:
        self.t += self.step
        return self.t
