"""``torch.profiler`` hooks: named ranges + on-demand capture windows (port
of :mod:`repro.obs.prof`, which drives ``jax.profiler``).

Two cheap bridges between the serving/training host loops and PyTorch's
profiler, both default-off:

* :class:`Prof` — ``prof.annotate("decode")`` wraps a host-side dispatch
  in a ``torch.profiler.record_function`` range, so prefill / decode show
  up as named rows (and as ``gpu_user_annotation`` spans over their
  kernels) in a captured trace.  Disabled (the default), ``annotate``
  returns one shared no-op context manager — no allocation, no torch
  call — which is the entirety of the engine's profiling overhead when
  off.

* :class:`ProfileWindow` — parses the launcher's ``--profile-ticks A:B``
  and runs a ``torch.profiler.profile`` (CPU activity, plus CUDA when the
  device is a GPU) from the start of engine tick A to the end of tick B.
  On a GPU the session opens with a primer (:func:`start_profiler`).
  On stop it writes, into ``logdir``, the Chrome trace (``trace.json``),
  the ``key_averages()`` table sorted by device time
  (``key_averages.txt``) and :func:`summarize`'s digest
  (``summary.json``).  ``stop()`` is idempotent and also runs from
  ``Observability.close`` so a run that ends inside the window still
  flushes it.

:func:`summarize` reads a Chrome trace of a window of ``steps`` ticks or
train steps: the device's busy share of the window, the host's wall time
per step, the CUDA kernels launched per step and the kernels with the most
device time, and what the trace lost: kernel launches whose device
record is missing.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional, Tuple

import torch

__all__ = ["Prof", "ProfileWindow", "parse_tick_window", "start_profiler",
           "summarize"]

_NULL = contextlib.nullcontext()

#: trace-event categories that occupy the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace-event categories of the host's launch calls
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: ``torch.cuda._sleep``'s kernel, the primer a CUDA session opens with
PRIMER_KERNEL = "spin_kernel"
#: the least primer a CUDA session opens with: launches and host seconds.
#: On an H100 (torch 2.11, CUPTI 26) a session lost the device records of
#: its first kernel launches and kept their launch calls, more of them the
#: more sessions the process had run (``scripts/profile_primer.py`` counts
#: them); the primer's kernels take that loss instead of the window's
PRIMER_LAUNCHES = 2048
PRIMER_S = 0.02


class Prof:
    """Named-range annotation source; one shared no-op when disabled."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled

    def annotate(self, name: str):
        if not self.enabled:
            return _NULL
        return torch.profiler.record_function(name)


def parse_tick_window(spec: str) -> Tuple[int, int]:
    """``"A:B"`` -> (A, B), inclusive tick bounds, validated."""
    try:
        a_s, b_s = spec.split(":")
        a, b = int(a_s), int(b_s)
    except ValueError:
        raise ValueError(
            f"--profile-ticks wants 'A:B' (tick bounds), got {spec!r}")
    if a < 0 or b < a:
        raise ValueError(f"--profile-ticks needs 0 <= A <= B, got {spec!r}")
    return a, b


def profiler_for(device) -> "torch.profiler.profile":
    """A ``torch.profiler.profile`` over the CPU, plus CUDA when ``device``
    is a GPU."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def start_profiler(device) -> Tuple["torch.profiler.profile", int]:
    """``profiler_for(device)``, started, and its primer's launch count:
    on a GPU empty spin kernels follow, at least ``PRIMER_LAUNCHES`` and
    ``PRIMER_S`` of them, then a device synchronise, so the records a new
    session loses are the primer's.  Pass the count to
    :func:`write_profile`."""
    prof = profiler_for(device)
    prof.start()
    n = 0
    if torch.device(device).type == "cuda":
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            while n < PRIMER_LAUNCHES or time.perf_counter() - t0 < PRIMER_S:
                torch.cuda._sleep(0)
                n += 1
        torch.cuda.synchronize(device)
    return prof, n


def _union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(trace: dict, steps: int, wall_s: float, top: int = 10,
              primer: int = 0) -> dict:
    """Digest of a Chrome trace (``export_chrome_trace``'s JSON) of a window
    of ``steps`` ticks or train steps that took ``wall_s`` on the host
    clock (ending in a device synchronise), opened by ``primer`` launches
    of ``PRIMER_KERNEL``, which nothing below counts but the last two:

    * ``device_busy_s`` — the union of the device's kernel, copy and set
      intervals; ``device_busy_share`` — that over ``wall_s``;
    * ``host_s_per_step`` — ``wall_s / steps``;
    * ``kernels`` / ``kernels_per_step`` — CUDA kernel events;
    * ``top`` — the ``top`` kernel names with the most device time:
      ``[name, count, device seconds]``;
    * ``primer_kernels`` — the primer's kernel events;
    * ``launches_lost`` — kernel launch calls whose correlation id no
      device event carries; ``window_launches_lost`` — those the
      primer's missing kernels do not account for: the window's own
      kernels the trace lost (0 for a whole trace).
    """
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    every = [e for e in events if e.get("cat") in DEVICE_CATS]
    dev = [e for e in every if PRIMER_KERNEL not in e["name"]]
    seen = {e.get("args", {}).get("correlation") for e in every}
    lost = sum(1 for e in events if e.get("cat") in LAUNCH_CATS
               and "LaunchKernel" in e["name"]
               and e.get("args", {}).get("correlation") not in seen)
    n_primer = len(every) - len(dev)
    busy_us = _union_us((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in dev)
    by_name = {}
    n_kernels = 0
    for e in dev:
        if e["cat"] == "kernel":
            n_kernels += 1
        cnt, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (cnt + 1, us + e.get("dur", 0.0))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "steps": steps, "wall_s": wall_s,
        "host_s_per_step": wall_s / max(steps, 1),
        "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / wall_s if wall_s > 0 else 0.0,
        "kernels": n_kernels, "kernels_per_step": n_kernels / max(steps, 1),
        "top": [[name, cnt, us * 1e-6] for name, (cnt, us) in ranked],
        "primer_kernels": n_primer, "launches_lost": lost,
        "window_launches_lost": lost - (primer - n_primer),
    }


def write_profile(prof, logdir: str, steps: int, wall_s: float,
                  primer: int = 0) -> dict:
    """Write ``prof``'s Chrome trace, its ``key_averages()`` table by
    device time and :func:`summarize`'s digest into ``logdir``; returns
    the digest.  ``primer``: the launches the session opened with
    (:func:`start_profiler`)."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        summary = summarize(json.load(f), steps, wall_s, primer=primer)
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    with open(os.path.join(logdir, "key_averages.txt"), "w") as f:
        f.write(table + "\n")
    with open(os.path.join(logdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


class ProfileWindow:
    """Run a ``torch.profiler`` capture across ticks [A, B].

    ``device`` picks the activities (CUDA only on a GPU); left None, the
    engine this window is attached to sets its own device.  After
    :meth:`stop`, ``summary`` holds :func:`summarize`'s digest.
    """

    def __init__(self, spec: str, logdir: str, device=None):
        self.start_tick, self.stop_tick = parse_tick_window(spec)
        self.logdir = logdir
        self.device = device
        self.active = False
        self.done = False
        self.summary: Optional[dict] = None
        self._prof = None
        self._primer = 0
        self._t0 = 0.0
        self._ticks = 0       # ticks begun inside the window

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type == \
                "cuda":
            torch.cuda.synchronize(self.device)

    def on_tick(self, tick_no: int) -> None:
        """Called once per engine tick, BEFORE the tick body runs."""
        if (not self.done and not self.active
                and tick_no >= self.start_tick):
            self._sync()
            self._prof, self._primer = start_profiler(self.device or "cpu")
            self._t0 = time.perf_counter()
            self.active = True
        elif self.active and tick_no > self.stop_tick:
            self.stop()
            return
        if self.active:
            self._ticks += 1

    def stop(self) -> None:
        if self.active:
            self._sync()
            wall = time.perf_counter() - self._t0
            self._prof.stop()
            self.summary = write_profile(
                self._prof, self.logdir, self._ticks, wall,
                primer=self._primer)
            self.active = False
        self.done = True
