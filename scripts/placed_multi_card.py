"""Train full-width configs with the state placed at rest across the
cards of one host, one process a card, and report each rank's memory and
step time.

    torchrun --standalone --nproc-per-node 4 scripts/placed_multi_card.py \\
        --train qwen3_1_7b:2:3 --train deepseek_67b:1:3 \\
        --out chiprun_out/placed_multi_card.json

Each ``--train ARCH:MODEL_PARALLEL:STEPS`` builds the train launcher's
pieces (``launch.train.build``: ``--sell acdc --sell-method pallas``,
batch 4 x 128 split over "data", the (data, model) mesh of the world size
and MODEL_PARALLEL) and trains STEPS steps from seed 0 with no
checkpoint.  Per rank: the bytes of its params and moments at rest (and
the full state's), the peak memory of the placed init and of the steps
(``torch.cuda.max_memory_allocated``), the losses and the s/step of the
steps after the first.  ``--replicated ARCH`` also trains that config
with its whole state on every rank, data-parallel over the same mesh's
"data" group and rows (what placement changes), and on rank 0 alone over
the whole global batch (the other ranks wait), for the losses to compare.
Rank 0 prints a line a run and writes every rank's numbers, with the
card's name and power limit, to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.dist import steps as steps_mod  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402

#: the device the ranks train on (a rehearsal on the CPU sets "cpu")
DEVICE = "cuda"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def launcher_args(arch: str, model_parallel: int, steps: int):
    return train.parse_args([
        "--arch", arch, "--sell", "acdc", "--sell-method", "pallas",
        "--global-batch", "4", "--seq-len", "128", "--steps", str(steps),
        "--model-parallel", str(model_parallel), "--device", DEVICE])


def train_steps(step_fn, state, batch_at, n: int) -> tuple:
    """(state, losses, seconds a step) of n synchronised steps."""
    losses, secs = [], []
    for s in range(n):
        batch = {k: t.to(DEVICE) for k, t in batch_at(s).items()}
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    return state, losses, secs


def placed_run(arch: str, model_parallel: int, steps: int) -> tuple:
    """(this rank's numbers, (cfg, model, opt, the batch source))."""
    args = launcher_args(arch, model_parallel, steps)
    cfg, model, opt, step_fn, pipeline = train.build(args)
    dp = pipeline.dp
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state = steps_mod.init_state(model, cfg, opt, gen, DEVICE, mesh=dp.mesh)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    at_rest = {k: state[k] for k in ("params", "opt")}
    out = dict(rank=dist.get_rank(),
               coord=[dp.mesh.get_local_rank(a) for a in ("data", "model")],
               mesh=list(dp.mesh.shape),
               rest_bytes=dp.placement.nbytes(at_rest),
               full_bytes=dp.placement.nbytes(at_rest, full=True),
               allocated_at_rest=torch.cuda.memory_allocated(),
               init_peak=init_peak)
    del at_rest
    torch.cuda.reset_peak_memory_stats()
    state, losses, secs = train_steps(step_fn, state, pipeline.batch_at,
                                      steps)
    out.update(step_peak=torch.cuda.max_memory_allocated(), losses=losses,
               s_per_step=sum(secs[1:]) / max(len(secs) - 1, 1),
               step_s=secs)
    del state
    torch.cuda.empty_cache()
    return out, (cfg, model, opt, pipeline)


def replicated_run(pieces, steps: int, group=None) -> dict:
    """The whole state: data-parallel over ``group`` on this rank's rows,
    or (no group) this process alone on the whole global batch."""
    cfg, model, opt, pipeline = pieces
    step_fn = steps_mod.make_train_step(model, cfg, opt, group=group)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state = steps_mod.init_state(model, cfg, opt, gen, DEVICE)
    state, losses, secs = train_steps(
        step_fn, state, pipeline.batch_at if group is not None
        else pipeline.source.batch_at, steps)
    out = dict(losses=losses,
               s_per_step=sum(secs[1:]) / max(len(secs) - 1, 1),
               peak=torch.cuda.max_memory_allocated())
    del state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="append", required=True,
                    help="ARCH:MODEL_PARALLEL:STEPS (repeatable; not "
                         "--run, which torchrun takes for --run-path)")
    ap.add_argument("--replicated", action="append", default=[],
                    help="ARCH also trained on rank 0 alone")
    ap.add_argument("--out", default="chiprun_out/placed_multi_card.json")
    args = ap.parse_args()
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("placed_multi_card: no CUDA device", file=sys.stderr)
        return 2
    mesh_mod.init_process_group(DEVICE)
    rank = dist.get_rank()
    report = {"device": smi(), "world": dist.get_world_size(), "runs": []}
    try:
        for spec in args.train:
            arch, mp, n = spec.split(":")
            mine, pieces = placed_run(arch, int(mp), int(n))
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, mine)
            run = dict(arch=arch, model_parallel=int(mp), ranks=ranks)
            if arch in args.replicated:
                run["data_parallel"] = replicated_run(
                    pieces, int(n), pieces[3].dp.group)
                if rank == 0:
                    run["replicated"] = replicated_run(pieces, int(n))
                dist.barrier()
            del pieces
            report["runs"].append(run)
            if rank == 0:
                gb = 1e9
                print(f"[placed] {arch} mesh {ranks[0]['mesh']} "
                      f"({report['device']}): at rest "
                      f"{[round(r['rest_bytes'] / gb, 3) for r in ranks]} GB"
                      f" of {ranks[0]['full_bytes'] / gb:.3f}; peak init "
                      f"{[round(r['init_peak'] / gb, 2) for r in ranks]}, "
                      f"steps {[round(r['step_peak'] / gb, 2) for r in ranks]}"
                      f" GB; s/step {[round(r['s_per_step'], 4) for r in ranks]}"
                      f"; losses {ranks[0]['losses']}"
                      + (f"; replicated data-parallel "
                         f"{run['data_parallel']}, on one card "
                         f"{run['replicated']}" if "replicated" in run
                         else ""), flush=True)
        if rank == 0:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(report, indent=1))
    finally:
        mesh_mod.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
