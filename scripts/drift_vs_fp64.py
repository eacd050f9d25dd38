#!/usr/bin/env python3
"""Each side's drift from an fp64-summed path, at full width on a GPU.

    python3 scripts/drift_vs_fp64.py [--arch A ...] [--out FILE]   # repo root

For each architecture (default Seamless-M4T-large-v2 and Qwen3-1.7B, at
``--sell acdc --sell-method pallas``): one prefill's and one decode
step's logits in bf16 and fp32 compute (``chip_smoke.logits_drift``) and
one AdamW step's fp32 loss gradients at 4 x 128 tokens
(``chip_smoke.compare_grads``), each with the kernels, the plain
versions, every SELL kernel summed in fp64 (``chip_smoke.kernels_in_fp64``)
and a faulty control.  Where the plain versions themselves drift as far
from fp64 as the kernels differ from them, a fixed kernels-vs-plain limit
tells no fault; these readings are what ``chip_smoke.py``'s holds for
Mamba2, Zamba2 and Seamless-M4T rest on.  Results print and go to
``--out`` (default ``chiprun_out/drift_vs_fp64.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", action="append",
                    help="architecture (repeatable; default "
                         "seamless_m4t_large_v2 and qwen3_1_7b)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "drift_vs_fp64.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("drift_vs_fp64: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from repro_torch.dist import steps as steps_mod
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train

    build.build_all()
    dev = torch.device("cuda", 0)
    out = {"device": cs.smi_line()}
    for arch in args.arch or ["seamless_m4t_large_v2", "qwen3_1_7b"]:
        flags = ["--arch", arch, "--sell", "acdc", "--sell-method", "pallas",
                 "--device", "cuda"]
        pieces = cs.model_for({}, flags)
        frames = serve._make_frontend(
            pieces[0], torch.Generator().manual_seed(7), 1)
        frames = None if frames is None else frames.to(dev)
        out[arch] = {dtype: cs.logits_drift(f"{arch} full width", pieces,
                                            dev, dtype, frames)
                     for dtype in ("bfloat16", "float32")}
        del pieces
        cs.release_memory()
        targs = train.parse_args(flags + ["--global-batch", "4",
                                          "--seq-len", "128"])
        cfg, model, opt, _, pipeline = train.build(targs)
        state = steps_mod.init_state(
            model, cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)
        out[arch]["grads"] = cs.compare_grads(
            model, dataclasses.replace(cfg, dtype="float32"),
            state["params"], train.batch_on(pipeline, 0, dev), arch,
            fp64=True)
        del state
        cs.release_memory()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
