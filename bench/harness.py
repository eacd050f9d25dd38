"""The harness: one run of one cell, driven by data.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:

* a configuration's ``file`` (``bench/configs/<name>.json``): its
  ``model`` dict, the configuration as it is run;
* a workload's traffic, ``bench/traffic/<traffic>.json``: the mix's
  parameters, whose ``kind`` names the generator
  (``bench/traffic/<kind>.py``) and the runner (``bench/kinds/<kind>.py``);
* a per-layer metric's reader, ``bench/metrics/<name>.py``, whose
  ``read(art)`` takes the metric from the run's artefacts or returns
  None when there is nothing to read;
* a cell's limits, ``bench/limits/<workload>.json``: each number
  compared and its limit.

A later cell, configuration, mix or metric is new files and new
entries; no file here changes for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench")
OUT = os.path.join(BENCH, "out")

#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    """What a runner gets: the cell's data and the run's arguments."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: int,
                 device, t_start: float,
                 bench: Optional[dict] = None, model: Optional[dict] = None,
                 mix: Optional[dict] = None):
        bench = bench or benchmark()
        self.cell = find(bench["workloads"], workload, "workload")
        self.config = find(bench["configs"], self.cell["config"],
                           "configuration")
        self.workload, self.seed = workload, int(seed)
        self.seconds, self.trace = float(seconds), int(trace)
        self.device, self.t_start = device, t_start
        self.model = model or load_json(
            os.path.join(ROOT, self.config["file"]))["model"]
        self.mix = mix or load_json(os.path.join(
            BENCH, "traffic", f"{self.cell['traffic']}.json"))
        self.limits = load_json(os.path.join(
            BENCH, "limits", f"{workload}.json"))["limits"]
        self.out_dir = os.path.join(OUT, workload)
        self.bench = bench
        self.setup_s = None

    def open_window(self) -> float:
        """Mark the end of set-up; returns the window's start."""
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        return now

    def runner(self):
        return importlib.import_module(f"bench.kinds.{self.mix['kind']}")


def judge(checks: dict, limits: dict) -> dict:
    """``{name: [value, limit]}`` in the limits file's order."""
    missing = set(limits) - set(checks)
    if missing:
        raise RuntimeError(f"numbers the run did not compare: {missing}")
    return {k: [checks[k], limits[k]] for k in limits}


def passed(judged: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in judged.values())


def card() -> dict:
    """The card's name, count and power limit."""
    import subprocess

    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        out["power_limit"] = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "not read"
    return out


def execute(ctx: Run) -> dict:
    """Run the cell once; returns the result line's object (with the
    artefacts beside it under ``art``)."""
    res = ctx.runner().run(ctx)
    metrics = {}
    if ctx.trace:
        art = res["art"]
        for m in ctx.bench["per_layer"]:
            if applies(m, ctx.workload):
                v = load_reader(m["name"])(art)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(res["e2e"], setup_s=ctx.setup_s)
        for m in ctx.bench["end_to_end"]:
            if applies(m, ctx.workload):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    judged = judge(res["checks"], ctx.limits)
    out = {"correct": passed(judged) and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": res["device"]}
    if ctx.trace and "trace" in res["art"]:
        t = res["art"]["trace"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = judged
    out["art"] = res["art"]
    out["readings"] = res.get("readings")
    return out
