"""A training cell's limits from the readings of ``readings.py``, by
the rule PERF.md gives:

* the lower reading of a number is the largest the program gives over
  its seeds;
* its upper reading is the smallest of: the control's, where that is
  ``CANDIDATES[name]`` times the lower or more (three, but where
  PERF.md gives the cause); the half-batch fault's, where ten times;
  the frozen state's (from the whole runs), where three times; the
  control's readings are those of ``readings.py`` and of its whole runs;
* of ``CANDIDATES``, a number with no upper reading is not compared;
* the limit is ``lower^(1/3) * upper^(2/3)``, to three figures: more
  room above the lower than below the upper.

It prints each number's readings and fails where the control or a fault
would come out as correct on any seed it was read on.

    python3 bench/tools/limits.py chiprun_out/readings.json \\
        bench/limits/<workload>.json
"""

import json
import math
import sys

#: the numbers a limit may be set for, each with the least ratio of the
#: control's smallest reading to the lower one: the first step's loss (the
#: later steps' drift swings the widest gap of the three), the first
#: gradient's and the change's gap of norms by the worst leaf, and the
#: differences by the median leaf.  In a model of top-k experts with
#: capacity, bf16 alone moves tokens across routing near-ties, which moves
#: every leaf's gradient (the reference in bf16 departs as far as the
#: program does), while the fp8 control's gradients decorrelate and
#: saturate near 1: the first gradient's difference separates the two by
#: about 2.2 x and no number of the step's outputs by more (PERF.md).
CANDIDATES = {"loss1_rel": 3.0, "grad1_gap": 3.0, "change3_gap": 3.0,
              "grad1_diff_median": 2.0, "change3_diff_median": 3.0}


def limits(readings: dict):
    """``({name: limit}, {name: (lower, upper, from)})``."""
    runs = whole_runs(readings)
    out, why = {}, {}
    for name, control_times in CANDIDATES.items():
        parts = {"control": (runs["control"], control_times),
                 "half_batch": (runs["half_batch"], 10.0),
                 "frozen": (runs["frozen"], 3.0)}
        lower = max(r[name] for r in readings["program"].values())
        ups = {part: min(r[name] for r in got.values())
               for part, (got, times) in parts.items()
               if got and min(r[name] for r in got.values())
               >= times * lower}
        if not ups:
            why[name] = (lower, None, None)
            continue
        src = min(ups, key=ups.get)
        lim = lower ** (1 / 3) * ups[src] ** (2 / 3)
        out[name] = float(f"{lim:.3g}")
        why[name] = (lower, ups[src], src)
    return out, why


def whole_runs(readings: dict) -> dict:
    """The control's and each fault's numbers by seed: ``readings.py``'s
    own and those of its whole runs."""
    out = {}
    for part in ("control", "half_batch", "frozen"):
        got = dict(readings.get(part, {}))
        for seed, r in readings.get("execute", {}).get(part, {}).items():
            got[f"run {seed}"] = r["numbers"]
        out[part] = got
    return out


def caught(readings: dict, lims: dict) -> dict:
    """For the control and each fault, the seeds on which no number
    passes its limit (none may be missing)."""
    return {part: [s for s, r in runs.items()
                   if not any(r[k] > v or not math.isfinite(r[k])
                              for k, v in lims.items())]
            for part, runs in whole_runs(readings).items()}


def main(argv=None) -> int:
    src, dst = (argv or sys.argv[1:])[:2]
    with open(src) as f:
        readings = json.load(f)
    lims, why = limits(readings)
    for name, (lower, upper, part) in why.items():
        print(f"{name}: lower {lower:.6g} upper "
              f"{'none' if upper is None else f'{upper:.6g} ({part})'} "
              f"limit {lims.get(name, 'not compared')}")
    missed = {p: s for p, s in caught(readings, lims).items() if s}
    with open(dst, "w") as f:
        json.dump({"limits": lims}, f, indent=1)
        f.write("\n")
    if missed:
        print(f"limits: correct on these seeds: {missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
