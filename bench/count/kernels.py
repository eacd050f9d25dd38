"""The kernel launches of a step from the configuration's shapes, and
each launch's least time on the card: the bound of its roofline share.

A launch's bound is the larger of two times: the bytes of every input
it is handed, read once, and of every output, written once, over the HBM
bandwidth; and its operations over the TF32 peak, which no fp32-accurate
product can pass.  ``scaled_matmul``'s operations are ``2 M K N``, a
matmul of the matrix it is handed; a cascade kernel's are counted as for
``mfu`` (:func:`bench.count.flops.acdc_row` a row, twice that for the
reverse sweep), and its transform matrices count as bytes because the
kernel is handed them.

Which kernel a SELL projection launches is the port's routing, written
here as arithmetic of its own (the reference's gates: a cascade up to
``MAX_FUSED_N`` fuses when its matrices, diagonals and row tiles fit
``VMEM_BUDGET``); the harness holds the inventory against the wrappers'
launch counters, so a routing that moves shows as a mismatch, not as a
wrong share.
"""

from __future__ import annotations

import collections
from typing import Dict, List, NamedTuple

from bench.count import flops
from bench.count import peaks

MAX_FUSED_N = 1024
VMEM_BUDGET = 14 * 1024 * 1024
_ROW_BLOCKS = (256, 128, 64, 32)
_BWD_ROW_BLOCKS = (256, 128, 64, 32, 16)


class Launch(NamedTuple):
    """``count`` launches of ``kernel`` moving ``bytes`` and computing
    ``ops`` each."""
    kernel: str
    bytes: float
    ops: float
    count: int

    def bound_s(self) -> float:
        """The least time of one launch on the card."""
        return max(self.bytes / peaks.HBM_BYTES_S, self.ops / peaks.TF32_FLOPS)


def cascade_fits(n: int, k: int, permute: bool) -> bool:
    if n > MAX_FUSED_N:
        return False
    mats = 3 if permute else 2
    return any(4 * (mats * n * n + 2 * k * n + 4 * bm * n) <= VMEM_BUDGET
               for bm in _ROW_BLOCKS)


def cascade_bwd_fits(n: int, k: int, permute: bool) -> bool:
    if n > MAX_FUSED_N or k < 2:
        return False
    mats = 3 if permute else 2
    return any(4 * (mats * n * n + 6 * k * n + (k - 1) * bm * n + 7 * bm * n)
               <= VMEM_BUDGET for bm in _BWD_ROW_BLOCKS)


def route(n: int, k: int, permute: bool) -> str:
    if k > 1 and cascade_fits(n, k, permute):
        return "cascade"
    return "fused" if n <= MAX_FUSED_N else "two_call"


def _smm(m: int, n: int, item: int, pre_rows: int, post: bool,
         count: int) -> Launch:
    """``y = (x * pre) @ C``, x (m, n) of ``item`` bytes, C (n, n) fp32,
    ``pre_rows`` rows of diagonals (0: none)."""
    nbytes = (2 * m * n * item + 4 * n * n + 4 * pre_rows * n
              + (4 * n if post else 0))
    return Launch("scaled_matmul", nbytes, 2.0 * m * n * n, count)


def projection_launches(cfg: dict, n: int, rows: int, groups: int,
                        count: int, train: bool, remat: bool,
                        item: int) -> List[Launch]:
    """Launches of ``count`` SELL projections at size ``n`` over ``rows``
    rows (``groups`` expert groups sharing them), in a forward (``train``
    False) or a train step (forward, the forward again under ``remat``,
    backward); activations of ``item`` bytes."""
    k, permute = cfg["sell_k"], cfg["sell_permute"]
    how = route(n, k, permute)
    fwd_times = (2 if remat else 1) if train else 1
    out = []
    if how == "two_call":
        out.append(_smm(rows, n, item, groups, False,
                        2 * k * fwd_times * count))
        if train:
            out.append(_smm(rows, n, 4, 0, False, k * count))
            out.append(_smm(rows, n, 4, groups, False, 2 * k * count))
        return out
    if how != "cascade":
        raise ValueError(f"no inventory for route {how!r} at N = {n}")
    mats = (3 if permute else 2) * 4 * n * n
    diags = 2 * 4 * k * n
    per_row = flops.acdc_row(cfg, n)
    m = rows // groups
    out.append(Launch("acdc_cascade", 2 * m * n * item + diags + mats,
                      m * per_row, groups * fwd_times * count))
    if train:
        if not cascade_bwd_fits(n, k, permute):
            raise ValueError(f"no inventory for the per-layer backward at "
                             f"N = {n}")
        out.append(Launch("acdc_cascade_bwd",
                          3 * m * n * item + 2 * diags + mats,
                          2 * m * per_row, groups * count))
    return out


def sell_projections(cfg: dict, rows: int, enc_rows: int = 0,
                     capacity_rows: int = 0) -> list:
    """``(role, n_in, n_out, rows, groups, count)`` of each projection
    of a pass over ``rows`` tokens (and an encoder's ``enc_rows``
    frames); an MoE layer's experts take ``capacity_rows`` rows in
    ``n_experts`` groups."""
    d = cfg["d_model"]
    dh = cfg["head_dim"] or d // cfg["n_heads"]
    nq = cfg["n_heads"] * dh
    n = cfg["n_layers"]

    def ffn(d_ff, r, g, c):
        return [("mlp_in", d, d_ff, r, g, 2 * c), ("mlp_out", d_ff, d, r, g, c)]

    out = []
    if cfg["family"] == "encdec":
        out.append(("attn_out", nq, d, rows, 1, 2 * n))
        out += ffn(cfg["d_ff"], rows, 1, n)
        if enc_rows:
            n_enc = cfg["n_encoder_layers"] or n
            out.append(("attn_out", nq, d, enc_rows, 1, n_enc))
            out += ffn(cfg["d_ff"], enc_rows, 1, n_enc)
    elif cfg["family"] == "decoder":
        out.append(("attn_out", nq, d, rows, 1, n))
        if cfg["n_experts"]:
            out += ffn(cfg["d_ff"], capacity_rows, cfg["n_experts"], n)
            if cfg["n_shared_experts"]:
                out += ffn(cfg["d_ff"] * cfg["n_shared_experts"], rows, 1, n)
        else:
            out += ffn(cfg["d_ff"], rows, 1, n)
    else:
        raise ValueError(f"no inventory for family {cfg['family']!r}")
    return [p for p in out if flops.uses_sell(cfg, p[0])]


def capacity(cfg: dict, tokens: int) -> int:
    """Rows each expert takes for ``tokens`` routed tokens."""
    return max(int(cfg["capacity_factor"] * tokens * cfg["top_k"]
                   / cfg["n_experts"]), 1)


def train_step(cfg: dict, rows: int, seq: int, frames: int = 0
               ) -> List[Launch]:
    """Every SELL kernel launch of one train step over ``rows`` x
    ``seq`` tokens (and ``frames`` encoder frames a row)."""
    if cfg["sell_kind"] != "acdc" or cfg["sell_method"] != "pallas":
        return []
    tokens = rows * seq
    cap = capacity(cfg, tokens) if cfg["n_experts"] else 0
    item = 2 if cfg["dtype"] == "bfloat16" else 4
    out = []
    for _, n_in, n_out, r, g, c in sell_projections(
            cfg, tokens, rows * frames, cfg["n_experts"] * cap):
        out += projection_launches(cfg, flops.n_op(n_in, n_out), r, g, c,
                                   True, cfg["remat"], item)
    return out


def totals(launches: List[Launch]) -> Dict[str, dict]:
    """By kernel: launches, and the sum of their bounds (s)."""
    out = collections.defaultdict(lambda: {"launches": 0, "bound_s": 0.0})
    for one in launches:
        out[one.kernel]["launches"] += one.count
        out[one.kernel]["bound_s"] += one.count * one.bound_s()
    return dict(out)
