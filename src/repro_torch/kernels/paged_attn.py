"""Paged-attention decode/verify — wrapper of ``csrc/paged_attn.cu``.

Port of :mod:`repro.kernels.paged_attn` (``paged_attention``).  One call
writes the T new tokens' K/V into their tail pages (the trash page when
unmapped or at/beyond the virtual row) and attends over each slot's
mapped prefix plus the new tokens, following the reference's mask
contract (see ``ref.paged_attention_ref``).

The pools are updated IN PLACE (the reference aliases them through
``input_output_aliases``); only the attention output is returned.

The kernel splits each (slot, KV head)'s keys over ``splits`` CTAs
(split-KV decode).  How is decided here, by :func:`plan`, from host
integers alone (slots, KV heads, table width, page size, query rows,
head dim, dtype): never from ``position``, whose read would synchronise
every tick.  Splits cover the virtual row ``MB * bs`` in whole pages; a
split beyond a slot's position streams nothing.  One split needs no
combine; up to ``CLUSTER_MAX`` are combined by a thread block cluster;
more through a workspace and a second kernel.

For CUDA tensors :func:`paged_attention` launches the kernel (or raises);
for CPU tensors it takes :func:`repro_torch.kernels.ref.paged_attention_ref`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

#: the kernel's per-(slot, head) limits (see the source)
MIN_HEAD_DIM = 16
MAX_HEAD_DIM = 128
MAX_ROWS = 16          # (n_heads / n_kv_heads) * T
MAX_T = 32

#: the plan's constants, set from ``scripts/paged_variants.py``'s timings
#: of every candidate on an H100: ~2 split CTAs an SM (the best split
#: counts of the long rows gave 256 CTAs; more only queue), the fewest
#: keys worth a split, the bytes of K and V of a tile (64-key tiles at
#: bf16, Dh 128 were best or within 3 %), the most splits a cluster
#: combines (above, the workspace route was as fast or faster)
TARGET_CTAS = 256
MIN_SPLIT_KEYS = 256
TILE_BYTES = 32768
CLUSTER_MAX = 8
#: the source's shared-memory limit a CTA
SMEM_LIMIT = 232448

ROUTES = ("single", "cluster", "two_pass")

#: kernel launches since the last reset (plain int; chip_smoke resets it)
launches = 0

_ARGS = ([build.VP] * 9 + [build.I32] * 9 + [build.F32, build.F32]
         + [build.I32] * 6 + [build.VP])
_DTYPES = (torch.float32, torch.bfloat16)


def fits(hkv: int, dh: int, group: int, t: int) -> bool:
    """Whether the kernel takes this head layout and query count."""
    return (MIN_HEAD_DIM <= dh <= MAX_HEAD_DIM and dh % 16 == 0
            and t <= MAX_T and group * t <= MAX_ROWS)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ``splits`` CTAs per (slot, KV head), split ``s``
    streaming pages ``[s * pages_per_split, (s + 1) * pages_per_split)``
    of the slot's table, ``kt`` keys a tile (two stages); ``route`` one
    of ``ROUTES``; ``threads`` and ``smem_bytes`` of a split CTA;
    ``workspace`` the fp32 shape the two-pass route writes."""
    splits: int
    pages_per_split: int
    kt: int
    route: str
    threads: int
    smem_bytes: int
    workspace: Optional[Tuple[int, ...]] = None

    def args(self) -> Tuple[int, ...]:
        """The plan's arguments of the C entry point, in order."""
        return (self.splits, self.pages_per_split, self.kt,
                ROUTES.index(self.route), self.smem_bytes)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dims_per_lane(rows: int) -> int:
    """Dims of q, k, v and the output a lane owns (the source's DPL): 16
    at most 2 query rows, else 8."""
    return 16 if rows <= 2 else 8


def lanes_per_key(dh: int, dpl: int) -> int:
    """Lanes sharing a key row, ``dpl`` dims each (the source's LPK)."""
    lanes = 1
    while lanes * dpl < dh:
        lanes *= 2
    return lanes


def rows_max(rows: int) -> int:
    """Query rows a row group of 4 warps holds (the source's RMAX)."""
    return 2 if rows <= 2 else 4


def smem_bytes(rows: int, t: int, dh: int, item: int, kt: int,
               pps: int) -> int:
    """A split CTA's shared memory (the source's ``Layout``): the two K/V
    stages (reused for the warps' states), the fp32 query rows, the CTA's
    state (dims padded to whole lanes), the T new tokens' K and V rows
    and write pages, and the split's ``pps`` pages."""
    rmax = rows_max(rows)
    rg = _cdiv(rows, rmax)
    dpl = dims_per_lane(rows)
    dp = dpl * lanes_per_key(dh, dpl)
    ring = 2 * 2 * kt * dh * item
    warps = 4 * rg * rmax * (dp + 2) * 4
    region = 16 * _cdiv(max(ring, warps), 16)
    return (region + rg * rmax * dp * 4 + rg * rmax * (dp + 2) * 4
            + 2 * t * dp * 4 + 16 * _cdiv(t, 4) + 16 * _cdiv(pps, 4))


def make_plan(b: int, hkv: int, mb: int, bs: int, group: int, t: int,
              dh: int, item: int, splits: int, kt: int, cluster: bool = True,
              cluster_max: int = CLUSTER_MAX) -> Plan:
    """The launch of ``splits`` (made whole pages: the fewest splits of
    that many pages that cover the table) at ``kt`` keys a tile; more
    than one split combines in a cluster where ``cluster`` and they are
    at most ``cluster_max`` (the source takes 16), else through the
    workspace."""
    pps = _cdiv(mb, max(1, min(splits, mb)))
    s = _cdiv(mb, pps)
    route = ("single" if s == 1 else
             "cluster" if cluster and s <= cluster_max else "two_pass")
    rows = group * t
    rg = _cdiv(rows, rows_max(rows))
    return Plan(s, pps, kt, route, 128 * rg,
                smem_bytes(rows, t, dh, item, kt, pps),
                (b, hkv, s, rows, dh + 2) if route == "two_pass" else None)


@functools.lru_cache(maxsize=1024)
def plan(b: int, hkv: int, mb: int, bs: int, group: int, t: int, dh: int,
         item: int) -> Plan:
    """The launch for B slots of Hkv heads, tables of MB pages of bs
    tokens, ``group * t`` query rows a (slot, head), head dim ``dh``,
    pools of ``item``-byte elements: enough splits that the (slot, head)
    pairs
    make ``TARGET_CTAS`` CTAs, but none of fewer than ``MIN_SPLIT_KEYS``
    keys; tiles of ``TILE_BYTES`` of K and V, at most the split's keys;
    the splits combined in a cluster where a CTA is one row group.  Pure
    Python, host integers only, cached."""
    if not (b >= 1 and hkv >= 1 and mb >= 1 and bs >= 1 and group >= 1
            and t >= 1 and fits(hkv, dh, group, t)):
        raise ValueError(f"paged_attn: no plan for B={b} Hkv={hkv} MB={mb} "
                         f"bs={bs} group={group} T={t} Dh={dh}")
    want = _cdiv(TARGET_CTAS, b * hkv)
    most = max(1, (mb * bs) // MIN_SPLIT_KEYS)
    splits = max(1, min(want, most, mb))
    pps = _cdiv(mb, splits)
    kt = TILE_BYTES // (2 * dh * item)
    kt = min(128, max(16, 16 * (kt // 16)), 16 * _cdiv(pps * bs, 16))
    # clusters of CTAs with more than one row group schedule poorly (at
    # T = 5: 0.24 ms a cluster of 4 against 0.16 through the workspace)
    one_group = group * t <= rows_max(group * t)
    return make_plan(b, hkv, mb, bs, group, t, dh, item, splits, kt,
                     cluster=one_group)


def plan_of(q: torch.Tensor, k_pages: torch.Tensor,
            block_tables: torch.Tensor) -> Plan:
    """:func:`plan` for a call's inputs."""
    b, t, hq, dh = q.shape
    hkv = k_pages.shape[2]
    return plan(b, hkv, block_tables.shape[1], k_pages.shape[1], hq // hkv,
                t, dh, k_pages.element_size())


@functools.lru_cache(maxsize=None)
def _launch_fn():
    return build.bind("paged_attn", "paged_attn_launch", _ARGS)


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int32 and t.is_contiguous() \
        else t.to(torch.int32).contiguous()


def launch(q: torch.Tensor, knew: torch.Tensor, vnew: torch.Tensor,
           k_pages: torch.Tensor, v_pages: torch.Tensor,
           block_tables: torch.Tensor, position: torch.Tensor, window: int,
           softcap: float, p: Plan) -> torch.Tensor:
    """Launch plan ``p`` on checked inputs (q, knew, vnew contiguous in
    the pools' dtype)."""
    b, t, hq, dh = q.shape
    hkv = knew.shape[2]
    n_pages, bs = k_pages.shape[0], k_pages.shape[1]
    ws = (None if p.workspace is None else
          torch.empty(p.workspace, dtype=torch.float32, device=q.device))
    out = torch.empty_like(q)
    err = _launch_fn()(
        q.data_ptr(), knew.data_ptr(), vnew.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), position.data_ptr(),
        out.data_ptr(), build.ptr(ws), b, t, hq, hkv, dh, n_pages, bs,
        block_tables.shape[1], int(window), float(softcap),
        float(dh ** -0.5), int(q.dtype == torch.bfloat16), *p.args(),
        build.stream_of(q.device))
    build.check(err, f"paged_attn {p}")
    return out


def paged_attention(q: torch.Tensor, knew: torch.Tensor, vnew: torch.Tensor,
                    k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, position: torch.Tensor,
                    window: int, *, softcap: float) -> torch.Tensor:
    """q (B, T, Hq, Dh), knew/vnew (B, T, Hkv, Dh), pools (NB+1, bs, Hkv,
    Dh), block_tables (B, MB) int32 (-1 unmapped), position (B,) int32,
    window a host int (0 = global).  Returns out (B, T, Hq, Dh)."""
    global launches
    b, t, hq, dh = q.shape
    hkv = knew.shape[2]
    if hq % hkv or knew.shape != (b, t, hkv, dh) or vnew.shape != knew.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"knew={tuple(knew.shape)} vnew={tuple(vnew.shape)}")
    knew = knew.to(k_pages.dtype)
    vnew = vnew.to(v_pages.dtype)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, knew, vnew, k_pages, v_pages,
                                       block_tables, position, int(window),
                                       float(softcap))
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    for name, tns in (("knew", knew), ("vnew", vnew), ("k_pages", k_pages),
                      ("v_pages", v_pages), ("block_tables", block_tables),
                      ("position", position)):
        if tns.device != q.device:
            raise ValueError(f"paged_attention: {name} on {tns.device}, "
                             f"q on {q.device}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: q {q.dtype} and pools "
                        f"{k_pages.dtype}/{v_pages.dtype} must share one "
                        f"dtype of {_DTYPES}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()
            and k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0):
        raise ValueError("paged_attention: pools must be contiguous (they "
                         "are written in place) and 16-byte aligned")
    if not fits(hkv, dh, hq // hkv, t):
        raise ValueError(
            f"paged_attention kernel needs Dh a multiple of 16 in "
            f"[{MIN_HEAD_DIM}, {MAX_HEAD_DIM}], T <= {MAX_T} and group*T <= "
            f"{MAX_ROWS}; got Dh={dh} T={t} group={hq // hkv}")
    out = launch(q.contiguous(), knew.contiguous(), vnew.contiguous(),
                 k_pages, v_pages, _int32(block_tables), _int32(position),
                 window, softcap, plan_of(q, k_pages, block_tables))
    launches += 1
    return out
