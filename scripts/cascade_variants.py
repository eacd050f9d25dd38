#!/usr/bin/env python3
"""Time every cluster launch of the ACDC cascade kernels on a GPU.

    python3 scripts/cascade_variants.py [--out FILE] [--quick]   # repo root

For each main-path shape of ``acdc_cascade`` (forward, K = 2 with the
riffle; K = 1 is ``acdc_fused``) and ``acdc_cascade_bwd`` (the reverse
sweep, K = 2 and 3 with the riffle; K = 1 is ``acdc_bwd``), every
candidate launch of ``kernels/acdc_cascade_fused.candidates``
(column split x row block, slices resident or streamed) is held against
the plain version (fp32 atol 2e-4, rtol 1e-3; bitwise on a repeat) and
timed by device time (``chip_smoke.device_ms``), beside
``cudaOccupancyMaxActiveClusters``, the cost model's estimate and the
plan the wrappers choose.  The times are what the cost model's constants
in ``kernels/acdc_cascade_fused.py`` are set from.  ``--quick`` checks the
chosen plans only (a first call of new kernels).  Results print and go to
``--out`` (default ``chiprun_out/cascade_variants.json``).
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

FWD_SHAPES = ((4, 128, 2), (4, 256, 2), (64, 256, 2), (256, 256, 2),
              (4, 1024, 2), (64, 1024, 2), (512, 1024, 2), (4, 256, 1))
BWD_SHAPES = ((256, 128, 2), (256, 256, 2), (256, 256, 3), (512, 1024, 2),
              (256, 128, 1), (256, 256, 1), (512, 1024, 1))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "cascade_variants.json")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cascade_variants: needs a GPU", file=sys.stderr)
        return 2

    import chip_smoke
    from repro_torch.core import families
    from repro_torch.kernels import acdc_cascade_bwd as bwd
    from repro_torch.kernels import acdc_cascade_fused as fwd
    from repro_torch.kernels import build, ref

    print(chip_smoke.smi_line(), flush=True)
    logs = build.build_all(["acdc_cascade", "acdc_cascade_bwd"])
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    fam = families.get_family("acdc")
    report = {"device": chip_smoke.smi_line(), "forward": [], "backward": []}
    bad = 0

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def mats(n):
        c, ct = fam.matrices(n, torch.float32, dev)
        perm = torch.as_tensor(fam.riffle(n), dtype=torch.long, device=dev)
        return c, ct, ct[:, perm].contiguous()

    def close(got, want):
        return bool(torch.allclose(got.float(), want.float(), rtol=1e-3,
                                   atol=2e-4 * max(1.0, float(
                                       want.float().abs().max()))))

    for m, n, k in FWD_SHAPES:
        c, ct, mid = mats(n)
        mid = mid if k > 1 else None
        x, a, d = randn(m, n), 1 + 0.061 * randn(k, n), 1 + 0.061 * randn(k, n)
        want = ref.acdc_cascade_ref(x, a, d, None, c, ct, mid)
        chosen = fwd.plan(m, n, k, mid is not None)
        plans = [chosen] if args.quick else list(fwd.candidates(
            m, n, chosen.vec, fwd.smem_of(k, mid is not None)))
        pms, _ = chip_smoke.device_ms(
            lambda: ref.acdc_cascade_ref(x, a, d, None, c, ct, mid))
        for p in plans:
            row = dict(shape=f"M={m} N={n} K={k}", plan=dataclasses.asdict(p),
                       chosen=p == chosen, model_us=fwd.cost_s(p, 2 * k) * 1e6,
                       plain_ms=pms)
            try:
                row["max_clusters"] = fwd.max_clusters(p, m, k,
                                                       mid is not None)
                got = fwd.launch_cascade(x, a, d, None, c, ct, mid, False, p)
                again = fwd.launch_cascade(x, a, d, None, c, ct, mid, False,
                                           p)
                torch.cuda.synchronize()
                row["ok"] = close(got, want) and torch.equal(got, again)
                row["max_abs_err"] = float((got - want).abs().max())
                row["ms"], row["host_us"] = chip_smoke.device_ms(
                    lambda: fwd.launch_cascade(x, a, d, None, c, ct, mid,
                                               False, p))
            except Exception as e:  # noqa: BLE001 -- recorded, not hidden
                row["ok"], row["error"] = False, repr(e)
            bad += not row["ok"]
            report["forward"].append(row)
            print(f"[fwd] {row['shape']} s={p.s} bm={p.bm} cpt={p.cpt} "
                  f"{'res' if p.resident else 'str'} smem={p.smem_bytes} "
                  f"{'*' if row['chosen'] else ' '} ok={row['ok']} "
                  f"ms={row.get('ms', float('nan')):.4f} (plain {pms:.4f}) "
                  f"model {row['model_us']:.1f} us clusters "
                  f"{row.get('max_clusters')} {row.get('error', '')}",
                  flush=True)

    for m, n, k in BWD_SHAPES:
        c, ct, mid = mats(n)
        riffle = k > 1        # K = 1, one layer (acdc_bwd), has no mid
        mid = mid if riffle else None
        x, g = randn(m, n), randn(m, n)
        a, d = 1 + 0.061 * randn(k, n), 1 + 0.061 * randn(k, n)
        want = (ref.acdc_cascade_bwd_ref(x, g, a, d, None, c, ct, mid)
                if riffle else ref.acdc_bwd_ref(x, g, a[0], d[0], c, ct,
                                                False))
        chosen = bwd.plan_bwd(m, n, k, riffle)
        plans = [chosen] if args.quick else list(fwd.candidates(
            m, n, chosen.vec, bwd.smem_of(k, riffle)))
        pms, _ = chip_smoke.device_ms(
            lambda: ref.acdc_cascade_bwd_ref(x, g, a, d, None, c, ct, mid))
        for p in plans:
            row = dict(shape=f"M={m} N={n} K={k}", plan=dataclasses.asdict(p),
                       chosen=p == chosen,
                       model_us=fwd.cost_s(p, 5 * k - 2) * 1e6, plain_ms=pms)
            try:
                row["max_clusters"] = bwd.max_clusters(p, m, k, riffle)
                got = bwd.launch_bwd(x, g, a, d, None, c, ct, mid, False, p)
                again = bwd.launch_bwd(x, g, a, d, None, c, ct, mid, False, p)
                torch.cuda.synchronize()
                got = tuple(u.reshape(w.shape) for u, w in zip(got[:3],
                                                               want[:3]))
                again = tuple(u.reshape(w.shape) for u, w in zip(again[:3],
                                                                 want[:3]))
                row["ok"] = all(close(u, w) and torch.equal(u, v) for u, v, w
                                in zip(got, again, want[:3]))
                row["max_abs_err"] = max(float((u - w).abs().max())
                                         for u, w in zip(got[:3], want[:3]))
                row["ms"], row["host_us"] = chip_smoke.device_ms(
                    lambda: bwd.launch_bwd(x, g, a, d, None, c, ct, mid,
                                           False, p))
            except Exception as e:  # noqa: BLE001 -- recorded, not hidden
                row["ok"], row["error"] = False, repr(e)
            bad += not row["ok"]
            report["backward"].append(row)
            print(f"[bwd] {row['shape']} s={p.s} bm={p.bm} cpt={p.cpt} "
                  f"{'res' if p.resident else 'str'} stash_smem="
                  f"{p.stash_smem} smem={p.smem_bytes} "
                  f"{'*' if row['chosen'] else ' '} ok={row['ok']} "
                  f"ms={row.get('ms', float('nan')):.4f} (plain {pms:.4f}) "
                  f"model {row['model_us']:.1f} us clusters "
                  f"{row.get('max_clusters')} {row.get('error', '')}",
                  flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(f"{bad} launches failed; report in {args.out}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
