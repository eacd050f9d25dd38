"""Where a dry-run cell's peak memory on the cards comes from: the CUDA
caching allocator's history around one call of the cell's step, beside
the dry run's own count of the same call.

    torchrun --standalone --nproc-per-node 4 scripts/cell_peak_trace.py \\
        --cell mamba2_1_3b:prefill:256:4:1x4:bfloat16 \\
        --out chiprun_out/cell_peak_trace.json

Each ``--cell ARCH:KIND:SEQ:BATCH:MESH[:DTYPE]`` is built on the cards as
``placed_multi_card.py --cell`` builds it (``dryrun.build_cell``, ``acdc``
on ``auto``) and called once to warm up.  Then, on every rank: one call
under ``dryrun.measure`` (the peak of the storages its dispatched ops
allocate, ``LiveBytes``), and one call with the allocator's history
recorded (``torch.cuda.memory._record_memory_history``, Python frames):
its allocated bytes above those before the call, event by event, give
the peak, the allocation that reached it and the blocks live there, each
with the Python frames that made it.  The same call logs every storage a
dispatched op returns (``OutputLog``): a block no op returned (a
library's workspace, a collective's staging buffer, an op's internal
copy) is listed as ``unseen``, which the dry run's count cannot see.  Rank 0 writes every
rank's record, with the card's name and power limit, to ``--out`` and
prints a line a cell.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

#: blocks listed at the peak, largest first
TOP = 12


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


#: frames of the tracing itself, left out of a block's frames
_OWN = ("cell_peak_trace.py", "_python_dispatch.py", "_ops.py")


class OutputLog(TorchDispatchMode):
    """(data pointer, bytes) of every CUDA storage a dispatched op
    returns."""

    def __init__(self):
        super().__init__()
        self.seen: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in dryrun._tensors(out):
            if t.is_cuda:
                st = t.untyped_storage()
                self.seen.add((st.data_ptr(), st.nbytes()))
        return out


def _where(event: dict, depth: int = 4) -> list:
    """The innermost ``depth`` Python frames of a trace event."""
    frames = [f for f in event.get("frames", [])
              if not f["filename"].endswith(_OWN)]
    return [f"{Path(f['filename']).name}:{f['line']} {f['name']}"
            for f in frames[:depth]]


def peak_of(events: list, seen: set = frozenset()) -> dict:
    """The peak of the allocated bytes above the start of ``events`` (the
    allocator's trace of one device): an ``alloc`` adds its size, a
    ``free_requested`` takes it off (the allocated count falls when the
    block is freed, before a stream's use of it completes).  Returns the
    peak, the event that reached it, the largest blocks live then, and
    the blocks live then that no dispatched op returned (not in ``seen``,
    :class:`OutputLog`'s pairs) with their bytes."""
    live, total, peak, at, top, unseen = {}, 0, 0, None, [], []
    for e in events:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            total += e["size"]
            if total > peak:
                peak, at = total, e
                top = sorted(live.values(), key=lambda b: -b["size"])[:TOP]
                unseen = [b for b in live.values()
                          if (b["addr"], b["size"]) not in seen]
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)
            total -= e["size"]

    def block(b):
        return {"size": b["size"], "frames": _where(b)}

    return {"peak_bytes": peak,
            "reached_by": None if at is None else block(at),
            "live_at_peak": [block(b) for b in top],
            "unseen_at_peak_bytes": sum(b["size"] for b in unseen),
            "unseen_at_peak": [block(b) for b in sorted(
                unseen, key=lambda b: -b["size"])[:TOP]]}


def trace_cell(spec: str) -> dict:
    arch, cell, shape, overrides = dryrun.parse_reckon(spec)
    fn, args = dryrun.build_cell(arch, cell, dryrun.mesh_of(shape, "cuda"),
                                 sell="acdc", cfg_overrides=overrides,
                                 device="cuda")
    fn(*args)
    torch.cuda.synchronize()
    _, rec = dryrun.measure(fn, args)
    del _
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    log = OutputLog()
    with log:
        out = fn(*args)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    measured = torch.cuda.max_memory_allocated() - before
    del out, fn, args
    torch.cuda.empty_cache()
    traced = peak_of(snap["device_traces"][torch.cuda.current_device()],
                     log.seen)
    return dict(reckoned_temp_bytes=rec["memory"]["temp_size_in_bytes"],
                measured_temp_bytes=measured, **traced)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH:KIND:SEQ:BATCH:MESH[:DTYPE]")
    ap.add_argument("--out", default="chiprun_out/cell_peak_trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cell_peak_trace: no CUDA device", file=sys.stderr)
        return 2
    mesh_mod.init_process_group("cuda")
    rank = dist.get_rank()
    report = {"device": smi(), "cells": []}
    try:
        for spec in args.cell:
            mine = trace_cell(spec)
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, mine)
            report["cells"].append(dict(spec=spec, ranks=ranks))
            if rank == 0:
                r0 = ranks[0]
                print(f"[trace] {spec} ({report['device']}): peak above the "
                      f"arguments {r0['measured_temp_bytes']} B measured, "
                      f"{r0['peak_bytes']} B traced, "
                      f"{r0['reckoned_temp_bytes']} B counted by the dry "
                      f"run; reached by {r0['reached_by']}; largest live: "
                      f"{r0['live_at_peak'][:4]}; live and returned by no "
                      f"op: {r0['unseen_at_peak_bytes']} B "
                      f"{r0['unseen_at_peak'][:6]}", flush=True)
        if rank == 0:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(report, indent=1))
    finally:
        mesh_mod.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
