"""How many kernel records a ``torch.profiler`` session loses, with and
without the primer ``obs.prof.start_profiler`` opens a session with: the
full-width Qwen3-1.7B decode windows of ``chip_smoke.py``'s phase 9 (two
steady ticks, dense and paged in turn), repeated in one process::

    python3 scripts/profile_primer.py [--windows 8] [--no-primer] \\
        [--out chiprun_out/profile_primer.json]

Each window's digest gives the launch calls whose device record the trace
lost (``launches_lost``), how many of them were the window's own
(``window_launches_lost``) and the window's ``scaled_matmul`` kernels
beside the wrapper's count; ``first_smm`` is the index of the window's
first ``scaled_matmul`` kernel among its kernels.  ``--no-primer`` opens
every session without one.  Prints the card's name and power limit, one
line a window, and writes the JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.obs import prof  # noqa: E402


def first_smm(logdir: Path):
    trace = json.loads((logdir / "trace.json").read_text())
    kernels = sorted((e for e in trace["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") == "kernel"
                      and prof.PRIMER_KERNEL not in e["name"]),
                     key=lambda e: e["ts"])
    return next((i for i, k in enumerate(kernels) if "smm_" in k["name"]),
                None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=8,
                    help="dense and paged windows each")
    ap.add_argument("--no-primer", action="store_true")
    ap.add_argument("--out", default="chiprun_out/profile_primer.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_primer: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    if args.no_primer:
        prof.PRIMER_LAUNCHES, prof.PRIMER_S = 0, 0.0
    misses = []
    cs._fail = misses.append          # a window that disagrees is reported
    dev = torch.device("cuda", 0)
    out = {"device": cs.smi_line(), "torch": torch.__version__,
           "primer": not args.no_primer, "windows": []}
    print(out["device"], torch.__version__, flush=True)
    build.build_all()
    root = ROOT / "build" / "profile_primer"
    with cs.plans_at_engine_build():
        pieces = serve.build(serve.parse_args([
            "--arch", "qwen3_1_7b", "--sell", "acdc", "--sell-method",
            "pallas", "--device", "cuda"]))
        for i in range(args.windows):
            for label, paged in (("decode paged", True),
                                 ("decode dense", False)):
                n0 = len(misses)
                label = f"{label} {i}"
                info = cs.profile_ticks(label, root, pieces, dev, paged, 0,
                                        4, 5)
                row = {k: info[k] for k in (
                    "kernels", "primer_kernels", "launches_lost",
                    "window_launches_lost")}
                row.update(label=label, first_smm=first_smm(root / label),
                           scaled_matmul=info["wrapper_launches"][
                               "scaled_matmul"],
                           mismatches=misses[n0:])
                out["windows"].append(row)
                print(json.dumps(row), flush=True)
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
