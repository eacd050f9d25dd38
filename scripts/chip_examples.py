"""Path N of ``chip_smoke.py`` on one card: the kernels' build, then each
PyTorch example's ``main`` in this process (``chip_smoke.examples_path``):
the quickstart whole, linear recovery, the convnet on ``acdc`` and
``dense``, the ~100M LM for 20 steps and serving.  The quick check of a
change to an example, without the whole smoke run::

    python3 scripts/chip_examples.py [--out chiprun_out/chip_examples.json]

Prints the card's name and power limit, torch's version and each
example's line; exits nonzero on any failed check.
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
    ap.add_argument("--out", default="chiprun_out/chip_examples.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_examples: no CUDA device", file=sys.stderr)
        return 2
    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build {build_s:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    totals = {k: 0 for k in cs.KERNEL_MODULES}
    t0 = time.perf_counter()
    info = cs.examples_path(dev, totals)
    info.update(path_s=time.perf_counter() - t0, build_s=build_s,
                device=cs.smi_line(), launches=totals)
    print(f"path N {info['path_s']:.1f} s; launches {totals}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(info, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
