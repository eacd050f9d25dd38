"""Arithmetic the per-layer readers share."""

import sys


def roofline(art: dict, *kernels: str):
    """Σ bound / Σ device time of ``kernels``' launches in the traced
    stretch, in %; None where none ran, or where the launches the trace
    and the wrappers' counters saw differ from the counted inventory."""
    t, inv = art.get("trace"), art.get("inventory")
    if not t or not inv:
        return None
    bound = dev = 0.0
    for k in kernels:
        want = inv.get(k, {}).get("launches", 0)
        seen = art.get("launch_counters", {}).get(k, 0)
        if want != seen:
            print(f"bench: {k}: {seen} launches counted, {want} in the "
                  f"inventory; no roofline read", file=sys.stderr)
            return None
        bound += inv.get(k, {}).get("bound_s", 0.0)
        dev += t["kernels"].get(k, {}).get("device_s", 0.0)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev
