#!/usr/bin/env python3
"""Time variants of scaled_matmul's tensor-core regime on a GPU, and the
card's mma.sync TF32 ceiling.

    python3 scripts/smm_variants.py [--out FILE]   # repository root, one GPU

Each variant rebuilds ``src/repro_torch/csrc/scaled_matmul.cu`` with
other tensor-core tiles defined (``SMM_TC_TILE_BIG`` / ``_SMALL``: rows,
columns, warps along M and N, two-level sums, ring stages), all builds
at once, and runs both tiles at their main-path shapes (M = 512 fp32 and
M = 64 bf16 x, K = N = 6144, the ACDC DCT matrix) over a few K splits:
device time, FLOP/s, and the fp32 error against fp64 relative to max |y|
beside ``torch.matmul``'s (cuBLAS fp32).  Then it builds and runs
``scripts/mma_tf32_peak.cu``.  Results print and go to ``--out``
(default ``build/variants/smm_variants.json``); the build goes to
``build/variants``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: name -> (128-row tile, 64-row tile); the first is the shipped pair
VARIANTS = {
    "shipped": ("128, 128, 4, 2, true, 3", "64, 128, 2, 2, true, 4"),
    "one accumulator": ("128, 128, 4, 2, false, 3",
                        "64, 128, 2, 2, false, 4"),
    "warps 2 x 4, 4 stages": ("128, 128, 2, 4, true, 4",
                              "64, 128, 2, 4, true, 4"),
    "warps 4 x 2, 4 stages": ("128, 128, 4, 2, true, 4",
                              "64, 128, 1, 4, true, 4"),
}
SPLITS = {512: (1, 2, 4), 64: (4, 8, 11)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "variants" / "smm_variants.json")
    args = ap.parse_args()

    from repro_torch.core import families
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import scaled_matmul as smm

    if not torch.cuda.is_available():
        print("smm_variants: needs a GPU", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (big, small)) in enumerate(VARIANTS.items()):
        src = out_dir / f"v{i}.cu"
        src.write_text(f"#define SMM_TC_TILE_BIG {big}\n"
                       f"#define SMM_TC_TILE_SMALL {small}\n"
                       f"#include \"{build.CSRC / 'scaled_matmul.cu'}\"\n")
        lib = out_dir / f"libv{i}.so"
        jobs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    peak = subprocess.run(
        [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-o", str(out_dir / "mma_tf32_peak"),
         str(ROOT / "scripts" / "mma_tf32_peak.cu")],
        capture_output=True, text=True)
    fns = {}
    for name, (proc, lib) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: build failed\n{text}", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(lib)).smm_launch
        fn.argtypes, fn.restype = smm._ARGS, ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 6144
    c, _ = families.get_family("acdc").matrices(n, torch.float32, dev)
    pre = 1.0 + 0.061 * torch.randn(n, generator=gen, device=dev)

    def time_ms(fn, reps=10):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    rows = []
    for m, dtype, tile in ((512, torch.float32, 0), (64, torch.bfloat16, 1)):
        x = torch.randn(m, n, generator=gen, device=dev).to(dtype)
        xf = x.float()
        y64 = (xf.double() * pre.double()) @ c.double()
        scale = float(y64.abs().max())
        cublas = dict(ms=time_ms(lambda: torch.matmul(xf, c)), err=float(
            (ref.scaled_matmul_ref(xf, c, pre=pre).double() - y64).abs()
            .max()) / scale)
        print(f"M={m} {dtype}: torch.matmul {cublas['ms']:.4f} ms, fp32 "
              f"err {cublas['err']:.2e}", flush=True)
        for name, fn in fns.items():
            bm, bn = (int(v) for v in VARIANTS[name][tile].split(",")[:2])
            for want in SPLITS[m]:
                splits, kc = smm._split_k(n, want)
                p = smm.Plan("tc", bm, bn, splits, kc, 4,
                             4 * splits * m * n if splits > 1 else 0)
                smm._smm_launch = lambda fn=fn: fn
                err = float((smm.launch(xf, c, pre, None, None, p).double()
                             - y64).abs().max()) / scale
                ms = time_ms(lambda: smm.launch(x, c, pre, None, None, p))
                rows.append(dict(variant=name, m=m, dtype=str(dtype),
                                 tile=[bm, bn], splits=splits, ms=ms,
                                 tflops=2.0 * m * n * n / ms / 1e9,
                                 fp32_err=err, cublas=cublas))
                print(f"  {name}: {bm} x {bn}, {splits} splits: {ms:.4f} ms"
                      f" ({rows[-1]['tflops']:.1f} TFLOP/s), fp32 err "
                      f"{err:.2e} ({err / cublas['err']:.2f} x cuBLAS)",
                      flush=True)
    peak_out = (subprocess.run([str(out_dir / "mma_tf32_peak")],
                               capture_output=True, text=True).stdout
                if peak.returncode == 0 else peak.stderr)
    print(peak_out, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(
        dict(device=smi, rows=rows, mma_tf32_peak=peak_out), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
