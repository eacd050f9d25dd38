"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The program is the PyTorch and CUDA port
under ``src/repro_torch``; this process never loads ``jax`` or the JAX
package.  Without a CUDA card (or with fewer than the cell asks for) it
exits nonzero and prints no result.  With ``--trace 0`` the result's
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones.  Its last line on standard output is the result as one JSON
object; its last lines on standard error are each number compared
beside its limit.  The run's artefacts go to ``bench/out/<workload>/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the script's own folder would shadow modules by its files' names
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
# the program's kernels and launch plans are built into build/ of this
# checkout, at a fixed path, so only a checkout's first run builds them
os.environ["REPRO_AUTOTUNE_CACHE"] = "1"
os.environ["REPRO_AUTOTUNE_CACHE_PATH"] = os.path.join(
    ROOT, "build", "autotune_cache.json")
os.environ.setdefault("OMP_NUM_THREADS", "4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness

    bench = harness.benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = harness.Run(args.workload, args.seed, args.seconds, args.trace,
                      torch.device("cuda", 0), T_START, bench=bench)
    res = harness.execute(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: the run loaded forbidden modules: {bad}",
              file=sys.stderr)
        return 3
    res["device"] = dict(harness.card(), **res["device"])
    os.makedirs(ctx.out_dir, exist_ok=True)
    with open(os.path.join(ctx.out_dir, f"run_{args.seed}_{args.trace}.json"),
              "w") as f:
        json.dump(res, f, indent=1, default=str)
    art, readings = res.pop("art"), res.pop("readings")
    del art, readings
    line = json.dumps(res)
    sys.stdout.flush()
    for name, (value, limit) in res["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
