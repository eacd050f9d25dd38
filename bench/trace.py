"""The traced stretch of a ``--trace 1`` run: a ``torch.profiler``
session over the CPU and CUDA, opened with a primer, and its digest.

The primer and the interval arithmetic are copied from the program's
profiler helpers (which stay the program's): a new session loses the
device records of its first launches, so it opens with at least
``PRIMER_LAUNCHES`` empty spin kernels and a synchronise, and the
digest leaves the primer's kernels out.  The digest gives the device's
busy seconds (the union of kernel, copy and set intervals), device time
and launches by kernel name, the ten kernels with the most device time,
and the idle gaps inside the stretch summed by what the host was doing
(the innermost host operation running at the gap's start, under the
benchmark's own range around each step).
"""

from __future__ import annotations

import bisect
import json
import os
import re
import time
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
PRIMER_KERNEL = "spin_kernel"
PRIMER_LAUNCHES = 2048
PRIMER_S = 0.02


def start(device) -> "torch.profiler.profile":
    """A started profiler over CPU and CUDA, its primer run."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    n, t0 = 0, time.perf_counter()
    with torch.cuda.device(device):
        while n < PRIMER_LAUNCHES or time.perf_counter() - t0 < PRIMER_S:
            torch.cuda._sleep(0)
            n += 1
    torch.cuda.synchronize(device)
    return prof


def union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(host: list, starts: list, t: float, look: int = 4096) -> str:
    """The name of the latest-started host event running at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for h in host[max(0, i - look):i + 1][::-1]:
        if h["ts"] + h.get("dur", 0) > t:
            return h["name"]
    return "(no host op)"


def digest(trace: dict, range_name: str,
           patterns: Dict[str, str]) -> dict:
    """The stretch covered by the host ranges named ``range_name``:

    * ``busy_s``: the union of device intervals inside it;
    * ``span_s``: from the first range's start to the last one's end;
    * ``kernels``: for each of ``patterns`` (a name and the regex its
      kernels' names match), their device seconds and launches;
    * ``device_ops``: the ten kernel names with the most device time;
    * ``idle_gaps``: the device's idle seconds inside the stretch, summed
      by host activity, the ten largest.
    """
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("name") == range_name
              and e.get("cat") == "user_annotation"]
    if not ranges:
        return {}
    lo = min(e["ts"] for e in ranges)
    hi = max(e["ts"] + e["dur"] for e in ranges)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and PRIMER_KERNEL not in e["name"]
           and e["ts"] + e.get("dur", 0) > lo and e["ts"] < hi]
    busy = union((max(e["ts"], lo), min(e["ts"] + e.get("dur", 0), hi))
                 for e in dev)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0.0)
    kernels = {}
    for key, rx in patterns.items():
        hit = [e for e in dev if e.get("cat") == "kernel"
               and re.search(rx, e["name"])]
        kernels[key] = {"device_s": sum(e.get("dur", 0.0) for e in hit) * 1e-6,
                        "launches": len(hit)}
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e.get("name") != range_name),
                  key=lambda e: e["ts"])
    starts = [h["ts"] for h in host]
    gaps: Dict[str, float] = {}
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            what = _innermost(host, starts, s)
            gaps[what] = gaps.get(what, 0.0) + (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "span_s": (hi - lo) * 1e-6,
        "kernels": kernels,
        "device_ops": [[name, us * 1e-6] for name, us in top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def stop(prof, out_dir: str, range_name: str,
         patterns: Dict[str, str]) -> dict:
    """Stop ``prof``, digest its trace (written under ``out_dir`` for the
    digest only, then removed) and keep the digest there."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    out = digest(trace, range_name, patterns)
    with open(os.path.join(out_dir, "digest.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out
