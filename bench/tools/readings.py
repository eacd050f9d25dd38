"""The readings a training cell's limits are set from, and the runs
that show its check failing, in one process on the card:

* the program's numbers (``bench.kinds.train.compare``) over a dozen
  seeds or more: the lower readings;
* the control, the reference computed in fp8 in the program's place, on
  three seeds or more: the upper readings;
* the fault that leaves half of the batch out, planted in the reference
  put in the program's place, on three seeds or more (a step that
  returns its state unchanged reads ``change3_gap`` = 1 by the measure
  and needs no run);
* whole runs of the cell through :func:`bench.harness.execute`, for
  ``--seconds`` each, with the control and each planted fault in the
  program's place (:mod:`bench.tools.planted`), on three seeds or more:
  each has to come out as not correct against the cell's limits;
* with ``--bf16-seeds``, the reference in bf16 in the program's place:
  what the program's precision alone departs by (a witness).

    python3 bench/tools/readings.py --workload dsmoe.train.2x1024 \\
        --seeds 1 2 3 --control-seeds 1 2 3 --fault-seeds 1 2 3 \\
        --execute-seeds 4 5 6 --out chiprun_out/readings.json
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def dump(out: dict, path: str) -> None:
    """Write the readings so far (a call cut at its limit keeps them)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--bf16-seeds", type=int, nargs="*", default=[],
                    help="the reference in bf16 in the program's place: "
                         "what bf16 alone departs by")
    ap.add_argument("--execute-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="the window of each whole run")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from bench import device as dv
    from bench import harness
    from bench.kinds import train
    from bench.tools import planted
    from bench.traffic import train as gen

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    ctx = harness.Run(args.workload, 0, 0, 0, dev, time.perf_counter())
    model, mix = ctx.model, ctx.mix
    out = {"workload": args.workload, "card": harness.card(), "execute": {}}
    parts = {"program": args.seeds, "control": args.control_seeds,
             "half_batch": args.fault_seeds, "bf16": args.bf16_seeds}
    for part in parts:
        out[part] = {}
    for seed in sorted(set().union(*parts.values())):
        t0 = time.perf_counter()
        batches = gen.batches(mix, model, seed, dev)
        shapes = train.shapes_of(train.program_config(model))
        recs = {}
        if seed in args.seeds:
            prog = train.Program(model, mix, seed, dev)
            recs["program"] = prog.first_steps(batches, model, seed,
                                               mix["optimizer"]["b1"])
            del prog
            gc.collect()
            dv.free(dev)
        want = train.reference_record(model, mix, shapes, seed, batches, dev)
        if seed in args.control_seeds:
            recs["control"] = train.reference_record(
                model, mix, shapes, seed, batches, dev, arith="fp8")
        if seed in args.fault_seeds:
            recs["half_batch"] = train.reference_record(
                model, mix, shapes, seed,
                [planted.halved(b) for b in batches], dev)
        if seed in args.bf16_seeds:
            recs["bf16"] = train.reference_record(
                model, mix, shapes, seed, batches, dev, arith="bf16")
        for part, rec in recs.items():
            out[part][seed] = dict(train.compare(rec, want),
                                   losses=rec["losses"],
                                   ref_losses=want["losses"],
                                   worst=worst_leaves(rec, want))
        del recs, want
        gc.collect()
        dv.free(dev)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s "
              + json.dumps({k: out[k].get(seed) for k in parts}),
              flush=True)
        dump(out, args.out)
    for part in parts:
        vals = out[part].values()
        if vals:
            print(part, {k: [min(v[k] for v in vals), max(v[k] for v in vals)]
                         for k in NUMBERS})
    return execute_planted(args, out, dev)


NUMBERS = ("loss_rel", "loss1_rel", "grad1_gap", "grad1_median", "change3_gap",
           "change3_median", "grad1_diff", "grad1_diff_median",
           "change3_diff", "change3_diff_median")


def worst_leaves(rec: dict, want: dict, n: int = 3) -> dict:
    """The ``n`` leaves of the widest gaps of each kind."""
    from bench.kinds import train

    return {what: sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
            for what, gaps in train.per_leaf(rec, want).items()}


def execute_planted(args, out, dev) -> int:
    """Whole runs with the control and each fault in the program's
    place; 1 where any comes out as correct."""
    from bench import harness
    from bench.tools import planted

    for seed in args.execute_seeds:
        for name in planted.PLANTED:
            t0 = time.perf_counter()
            with planted.in_place(name):
                res = harness.execute(harness.Run(
                    args.workload, seed, args.seconds, 0, dev,
                    time.perf_counter()))
            got = res["readings"]
            out["execute"].setdefault(name, {})[seed] = {
                "correct": res["correct"], "checks": res["checks"],
                "numbers": got["numbers"]}
            print(f"{name} seed {seed}: {time.perf_counter() - t0:.1f} s "
                  + json.dumps(out["execute"][name][seed]), flush=True)
            dump(out, args.out)
    wrong = [(n, s) for n, runs in out["execute"].items()
             for s, r in runs.items() if r["correct"]]
    if wrong:
        print(f"readings: came out as correct: {wrong}", file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
