#!/usr/bin/env python3
"""Time every split-KV launch of the paged-attention kernel on a GPU.

    python3 scripts/paged_variants.py [--out FILE] [--quick]   # repo root

For each row of ``chip_smoke.PAGED_ROWS`` (the main path's decode and
verify rows and the long rows a - d, bf16 pools), every candidate launch
(splits, each combined by a thread block cluster of up to 16 or through
the workspace and a second kernel; keys a tile) is held against the
plain version (bf16 output: rtol 2^-7, atol 2e-2; pool writes equal;
bitwise on a repeat) and timed by device time (``chip_smoke.device_ms``)
beside the plan that ``kernels/paged_attn.plan`` chooses.  The times are
what the plan's constants (``TARGET_CTAS``, ``MIN_SPLIT_KEYS``,
``TILE_BYTES``, ``CLUSTER_MAX``) are set from.  ``--quick`` checks the
chosen plans and, where they split, the other combine route for identical
bits (a first call of a new kernel).  Results print and go to ``--out``
(default ``chiprun_out/paged_variants.json``).
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

SPLITS = (1, 2, 4, 8, 12, 16, 24, 32, 64, 128)
KTS = (16, 32, 64, 128)


def candidates(pa, b, mb, t, dh, item):
    """Every distinct launch over ``SPLITS`` x both combines x ``KTS``
    (keys a tile)."""
    seen = []
    for s in SPLITS:
        for cluster in (True, False):
            for kt in KTS:
                p = pa.make_plan(b, 8, mb, 16, 2, t, dh, item, s, kt,
                                 cluster=cluster, cluster_max=16)
                if p not in seen and p.smem_bytes <= pa.SMEM_LIMIT:
                    seen.append(p)
    return seen


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "paged_variants.json")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_variants: needs a GPU", file=sys.stderr)
        return 2

    import chip_smoke
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import paged_attn as pa

    print(chip_smoke.smi_line(), flush=True)
    logs = build.build_all(["paged_attn"])
    for line in logs["paged_attn"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            print(f"[ptxas] {line.strip()}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    report = {"device": chip_smoke.smi_line(), "rows": []}
    bad = 0

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for label, bsz, length, t in chip_smoke.PAGED_ROWS:
        q, kn, vn, kp, vp, tables, pos = chip_smoke.paged_case(
            dev, randn, bsz, length, t)
        kp2, vp2 = kp.clone(), vp.clone()
        want = ref.paged_attention_ref(q, kn, vn, kp2, vp2, tables, pos, 0,
                                       0.0)
        chosen = pa.plan_of(q, kp, tables)
        mb = tables.shape[1]
        if args.quick:
            plans = [chosen]
            if chosen.splits > 1:   # the other combine route
                plans.append(pa.make_plan(
                    bsz, 8, mb, 16, 2, t, 128, 2, chosen.splits, chosen.kt,
                    cluster=chosen.route != "cluster", cluster_max=16))
        else:
            plans = candidates(pa, bsz, mb, t, 128, 2)
        nbytes, flops, streamed = chip_smoke.paged_bytes_flops(q, kp, tables,
                                                               pos)
        bound, _ = chip_smoke.bound_ms(nbytes, flops)
        first = None
        for p in plans:
            row = dict(row=label, shape=f"B={bsz} pos={length} T={t}",
                       plan=dataclasses.asdict(p), chosen=p == chosen,
                       bound_ms=bound)
            try:
                kc, vc = kp.clone(), vp.clone()

                def run():
                    return pa.launch(q, kn, vn, kc, vc, tables, pos, 0, 0.0,
                                     p)

                got, again = run(), run()
                torch.cuda.synchronize()
                row["ok"] = (chip_smoke.rel_close(got, want, rtol=2 ** -7,
                                                  atol=2e-2)
                             and torch.equal(got, again)
                             and torch.equal(kc[:-1], kp2[:-1])
                             and torch.equal(vc[:-1], vp2[:-1]))
                row["max_abs_err"] = chip_smoke.max_err(got, want)
                if p.splits > 1:   # every split count gives its own bits;
                    # the two combines of one count must agree
                    key = (p.splits, p.kt)
                    first = first or {}
                    if key in first:
                        row["same_bits_as_other_route"] = torch.equal(
                            got, first[key])
                        row["ok"] &= row["same_bits_as_other_route"]
                    else:
                        first[key] = got
                row["ms"], row["host_us"] = chip_smoke.device_ms(run)
                row["gb_s"] = streamed / row["ms"] / 1e6
            except Exception as e:  # noqa: BLE001 -- recorded, not hidden
                row["ok"], row["error"] = False, repr(e)
            bad += not row["ok"]
            report["rows"].append(row)
            print(f"[paged] {label} {row['shape']} splits={p.splits} "
                  f"pps={p.pages_per_split} kt={p.kt} {p.route} "
                  f"smem={p.smem_bytes} {'*' if row['chosen'] else ' '} "
                  f"ok={row['ok']} ms={row.get('ms', float('nan')):.4f} "
                  f"({row.get('gb_s', 0):.0f} GB/s; bound {bound:.4f}) "
                  f"{row.get('error', '')}", flush=True)
        del q, kn, vn, kp, vp, kp2, vp2
        torch.cuda.empty_cache()

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(f"{bad} launches failed; report in {args.out}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
