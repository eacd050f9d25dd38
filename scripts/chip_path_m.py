"""Path M of ``chip_smoke.py`` alone, on one card: the kernels' build, then
placed serving beside the unplaced steps and the dry run's reckoning
against the card (``chip_smoke.placed_serving``) on a world-of-one NCCL
group.  The quick check of a change to placed serving or to the dry run,
without the whole smoke run's twenty minutes::

    python3 scripts/chip_path_m.py [--out chiprun_out/chip_path_m.json]

Prints the card's name and power limit, torch's version and each of path
M's lines; raises on any failed check.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/chip_path_m.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_path_m: no CUDA device", file=sys.stderr)
        return 2
    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    totals = {k: 0 for k in cs.KERNEL_MODULES}
    with cs.world_of_one(dev):
        t0 = time.perf_counter()
        info = cs.placed_serving(dev, totals)
        info["path_s"] = time.perf_counter() - t0
    print(f"path M {info['path_s']:.1f} s; launches {totals}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(info, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
