"""Whole-cascade ACDC forward — wrapper of ``csrc/acdc_cascade.cu``.

Port of :mod:`repro.kernels.acdc_cascade_fused` (``acdc_cascade_pallas``):
an order-K cascade ``h <- ((h*a_i) C * d_i + b_i) (C^T or ct_mid)`` with
ReLU between layers and the fp32 activation resident on chip, x read once
and y written once.  ``ct_mid = C^T[:, riffle]`` folds the permutation
into the mid-cascade matrix.

Routing (whether a cascade goes here at all) is decided in
:mod:`repro_torch.kernels.ops` with the reference's own arithmetic.  How
a launch is cut is decided here, by :func:`plan`, from the shapes alone
(pure Python: the CPU tests reach it): one thread block cluster of
``s`` CTAs per ``bm`` rows, CTA ``r`` owning output columns
``[r * width, (r + 1) * width)`` of every product, the transform slices
resident in shared memory or streamed from L2, and the shared memory
that takes.  :func:`plan_bwd` in :mod:`.acdc_cascade_bwd` cuts the
reverse sweep the same way.

For a CUDA tensor :func:`acdc_cascade` launches the kernel (or raises,
also when the card cannot schedule the plan's cluster); for a CPU tensor
it takes :func:`repro_torch.kernels.ref.acdc_cascade_ref`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

#: largest N the kernel takes, the reference's ``MAX_FUSED_N``
KERNEL_MAX_N = 1024

#: kernel launches since the last reset (plain int; chip_smoke resets it)
launches = 0

_ARGS = [build.VP] * 8 + [build.I32] * 13 + [build.VP]
_DTYPES = (torch.float32, torch.bfloat16)

#: streaming multiprocessors of an H100 SXM, and a CTA's shared memory
#: limit and an SM's whole shared memory (bytes)
SMS = 132
SMEM_LIMIT = 232448
SM_SMEM = 233472
#: warps a CTA (``kThreads / 32`` in the source), ring stages (``kStages``),
#: rows a cluster (template instances of the source), largest cluster
WARPS = 8
STAGES = 4
ROW_BLOCKS = (4, 8, 16)
COL_GROUPS = (1, 2, 4)
MAX_CLUSTER = 16
#: rows of a streamed tile, largest first (the ring holds STAGES tiles)
STREAM_KTS = (256, 128, 64, 32)
#: SMs whose CTAs a cluster of each size can use at once, from
#: ``cudaOccupancyMaxActiveClusters`` on an H100 SXM at one CTA an SM
#: (``scripts/cascade_variants.py``: 15 clusters of 8, 7 of 16)
CLUSTER_SMS = {1: 132, 2: 132, 4: 120, 8: 120, 16: 112}
#: the launch-cost model of :func:`cost_s` (seconds), fitted to the
#: device times of all 151 candidate launches of the main shapes on an
#: H100 (``scripts/cascade_variants.py``, chip run 4 of PR 14; rms error
#: 18 %): a launch's fixed cost, a product's (reduce, epilogue, cluster
#: barrier), the fp32 FMAs an SM sustains from shared memory, the latency
#: of a streamed tile that the ring's STAGES - 1 tiles in flight hide, an
#: SM's bytes a second from L2, and a streamed tile's barrier
LAUNCH_S = 0.4e-6
PRODUCT_S = 2.3e-6
FMA_PER_SM_S = 1.0e11
TILE_LATENCY_S = 1.0e-6
L2_PER_SM_BYTES_S = 67e9
TILE_S = 0.53e-6


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of a cascade kernel: clusters of ``s`` CTAs over ``bm``
    rows each (``clusters`` of them); CTA ``r`` owns output columns
    ``[r * width, min(n, (r + 1) * width))``, its threads cover ``cpt``
    32-column groups; products run ``nk`` deep (N padded to whole
    ``kt``-row tiles); the transform slices are ``resident`` or streamed
    through a ``STAGES``-deep ring; ``vec`` is 4 for 16-byte copies, 1 for
    4-byte ones.  Backward only: ``stash_smem`` (the stash's own columns
    in shared memory, else a global workspace)."""
    n: int
    s: int
    width: int
    cpt: int
    bm: int
    clusters: int
    nk: int
    kt: int
    resident: bool
    vec: int
    smem_bytes: int
    stash_smem: bool = False

    @property
    def lw(self) -> int:
        return 32 * self.cpt

    def slices(self) -> Tuple[Tuple[int, int], ...]:
        """Each CTA's ``[j0, j1)`` of the output columns, by rank."""
        return tuple((r * self.width, min(self.n, (r + 1) * self.width))
                     for r in range(self.s))

    def ctas(self) -> int:
        return self.s * self.clusters

    def args(self) -> Tuple[int, ...]:
        """The geometry arguments of the C entry points, in order."""
        return (self.s, self.width, self.cpt, self.bm, self.nk, self.kt,
                int(self.resident), int(self.vec == 4))


def mats_floats(nk: int, kt: int, lw: int, nmats: int, trans: bool,
                resident: bool) -> int:
    """Floats of the transform slices (``cl::mats_floats``)."""
    if resident:
        return nmats * nk * lw + (lw * (nk + 4) if trans else 0)
    return STAGES * (lw * (kt + 4) if trans else kt * lw)


def column_split(n: int, cpt: int, vec: int) -> Optional[Tuple[int, int]]:
    """``(s, width)``: the fewest CTAs whose slices of at most ``32 cpt``
    columns (a multiple of 4 with 16-byte copies) cover N, every CTA
    owning at least one column; None when that takes more than
    ``MAX_CLUSTER``."""
    s = _cdiv(n, 32 * cpt)
    if s > MAX_CLUSTER:
        return None
    width = _cdiv(n, s)
    if vec == 4:
        width = 4 * _cdiv(width, 4)
    return _cdiv(n, width), width


def candidates(m: int, n: int, vec: int, smem_of):
    """Every launch of x (m, n) over the column splits (``COL_GROUPS``)
    and row blocks (``ROW_BLOCKS``): the slices resident where they fit,
    else streamed in each tile size of ``STREAM_KTS`` that fits.
    ``smem_of(bm, lw, nk, kt, resident)`` gives ``(bytes, extra plan
    fields)``, or None above ``SMEM_LIMIT``."""
    nk = 32 * _cdiv(n, 32)
    for cpt in COL_GROUPS:
        split = column_split(n, cpt, vec)
        if split is None:
            continue
        s, width = split
        for bm in ROW_BLOCKS:
            got = smem_of(bm, 32 * cpt, nk, nk, True)
            if got is not None:
                yield Plan(n, s, width, cpt, bm, _cdiv(m, bm), nk, nk, True,
                           vec, got[0], **got[1])
                continue
            for kt in STREAM_KTS:
                got = smem_of(bm, 32 * cpt, nk, kt, False)
                if kt < nk and nk % kt == 0 and got is not None:
                    yield Plan(n, s, width, cpt, bm, _cdiv(m, bm), nk, kt,
                               False, vec, got[0], **got[1])


def ctas_per_sm(p: Plan) -> int:
    """CTAs of the plan an SM holds at once (shared memory bound)."""
    return max(1, min(8, SM_SMEM // (p.smem_bytes + 1024)))


def active_clusters(p: Plan) -> int:
    """Clusters of the plan the card runs at once (the model's guess of
    ``cudaOccupancyMaxActiveClusters``)."""
    sms = CLUSTER_SMS[min(k for k in CLUSTER_SMS if k >= p.s)]
    return max(1, ctas_per_sm(p) * sms // p.s)


def cost_s(p: Plan, products: int) -> float:
    """The launch-cost model: the waves of clusters the card runs at
    once times one CTA's time: ``LAUNCH_S``, and for each product
    ``PRODUCT_S`` plus its FMAs at ``FMA_PER_SM_S`` -- or, streamed, each
    tile's FMAs, copy from L2 or the part of its latency the ring does
    not hide, whichever is longest, and ``TILE_S``; CTAs that share an SM
    share its FMAs and its L2 bandwidth."""
    waves = _cdiv(p.clusters, active_clusters(p))
    share = min(ctas_per_sm(p), _cdiv(p.ctas(), SMS))
    fma = share * p.bm * p.lw * p.kt / FMA_PER_SM_S
    if not p.resident:
        fma = TILE_S + max(fma, share * 4 * p.kt * p.lw / L2_PER_SM_BYTES_S,
                           TILE_LATENCY_S / (STAGES - 1))
    cta = LAUNCH_S + products * (PRODUCT_S + fma * (p.nk // p.kt))
    return waves * cta


def choose(m: int, n: int, products: int, vec: int, smem_of) -> Plan:
    """The candidate the cost model rates fastest (ties: fewer CTAs)."""
    best = min(candidates(m, n, vec, smem_of),
               key=lambda p: (cost_s(p, products), p.ctas()), default=None)
    if best is None:
        raise ValueError(f"no cluster plan for M={m} N={n}")
    return best


@functools.lru_cache(maxsize=1024)
def plan(m: int, n: int, k: int, riffle: bool, vec_ok: bool = True) -> Plan:
    """The launch of the forward at x (m, n), K layers, with ct_mid
    (``riffle``) or not; ``vec_ok`` False forbids 16-byte copies (a
    transform not 16-byte aligned).  Pure Python and cached."""
    if not (1 <= n <= KERNEL_MAX_N and m >= 1 and k >= 1):
        raise ValueError(f"acdc cascade: no plan for M={m} N={n} K={k}")
    return choose(m, n, 2 * k, vec_width(n, vec_ok), smem_of(k, riffle))


def smem_of(k: int, riffle: bool):
    """The forward's shared memory as :func:`candidates` asks for it: h
    and h2 (bm x nk), the warps' partials (8 x bm x lw) and the transform
    slices (``acdc_cascade.cu``'s ``smem_bytes``)."""
    nmats = 3 if riffle and k > 1 else 2

    def bytes_of(bm, lw, nk, kt, resident):
        b = 4 * (2 * bm * nk + WARPS * bm * lw
                 + mats_floats(nk, kt, lw, nmats, False, resident))
        return (b, {}) if b <= SMEM_LIMIT else None

    return bytes_of


def vec_width(n: int, vec_ok: bool) -> int:
    """4 (16-byte copies of the transforms) when N and the addresses
    allow, else 1."""
    return 4 if vec_ok and n % 4 == 0 else 1


def aligned(*ts: Optional[torch.Tensor]) -> bool:
    """Whether every given tensor starts on a 16-byte boundary."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


_CHECKED = {}


def check_schedulable(lib: str, fn: str, p: Plan, key: tuple) -> int:
    """``cudaOccupancyMaxActiveClusters`` of plan ``p`` (cached): raises
    when the card cannot hold one of its clusters -- no fallback."""
    n = _CHECKED.get((lib, key))
    if n is None:
        n = build.bind(lib, fn, [build.I32] * len(key))(*key)
        if n < 0:
            build.check(-n, f"{lib} occupancy query {p}")
        _CHECKED[(lib, key)] = n
    if n == 0:
        raise ValueError(f"{lib}: the card cannot schedule a cluster of "
                         f"{p.s} CTAs with {p.smem_bytes} bytes of shared "
                         f"memory ({p})")
    return n


def max_clusters(p: Plan, m: int, k: int, riffle: bool) -> int:
    """How many of the forward plan's clusters the card holds at once."""
    key = (m, p.n, k, int(riffle), *p.args(), p.smem_bytes)
    return check_schedulable("acdc_cascade", "acdc_cascade_max_clusters", p,
                             key)


@functools.lru_cache(maxsize=1024)
def _geometry(m: int, n: int, k: int, riffle: bool, vec_ok: bool):
    """(plan, the C entry point's geometry arguments) of a shape, checked
    schedulable once: the launch path's one lookup."""
    p = plan(m, n, k, riffle, vec_ok)
    max_clusters(p, m, k, riffle)
    return p, (*p.args(), p.smem_bytes)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    return build.bind("acdc_cascade", "acdc_cascade_launch", _ARGS)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous fp32 (itself when it is already)."""
    return t if t.dtype == torch.float32 and t.is_contiguous() \
        else t.float().contiguous()


def launch_cascade(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   bias: Optional[torch.Tensor], c: torch.Tensor,
                   ct: torch.Tensor, ct_mid: Optional[torch.Tensor],
                   relu: bool, p: Optional[Plan] = None) -> torch.Tensor:
    """Validate and launch the CUDA kernel (shared with ``acdc_fused``),
    with :func:`plan`'s launch unless ``p`` is given.  The kernel runs in
    fp32: bf16 x is widened exactly and y rounded back once, where the
    kernel would round it."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"acdc cascade: x dtype {x.dtype} not in {_DTYPES}")
    m, n = x.shape
    k = a.shape[0]
    if n > KERNEL_MAX_N:
        raise ValueError(f"acdc cascade kernel takes N <= {KERNEL_MAX_N}, "
                         f"got {n}")
    dev = x.device
    for name, t, shape in (("a", a, (k, n)), ("d", d, (k, n)),
                           ("bias", bias, (k, n)), ("c", c, (n, n)),
                           ("ct", ct, (n, n)), ("ct_mid", ct_mid, (n, n))):
        if t is not None and (t.shape != shape or t.device != dev):
            raise ValueError(f"acdc cascade: {name} {tuple(t.shape)} on "
                             f"{t.device}, want {shape} on {dev}")
    xf = _f32(x)
    a, d, c, ct = _f32(a), _f32(d), _f32(c), _f32(ct)
    bias = None if bias is None else _f32(bias)
    riffle = ct_mid is not None and k > 1
    ct_mid = _f32(ct_mid) if riffle else None
    if p is None:
        p, geo = _geometry(m, n, k, riffle, aligned(c, ct, ct_mid))
    else:
        max_clusters(p, m, k, riffle)
        geo = (*p.args(), p.smem_bytes)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    err = _launch_fn()(
        xf.data_ptr(), a.data_ptr(), d.data_ptr(), build.ptr(bias),
        c.data_ptr(), ct.data_ptr(), build.ptr(ct_mid), y.data_ptr(), m, n,
        k, int(relu), *geo, build.stream_of(dev))
    build.check(err, f"acdc_cascade {p}")
    return y if x.dtype == torch.float32 else y.to(x.dtype)


def acdc_cascade(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                 bias: Optional[torch.Tensor], c: torch.Tensor,
                 ct: torch.Tensor, ct_mid: Optional[torch.Tensor], *,
                 relu: bool = False) -> torch.Tensor:
    """Fused order-K cascade over 2-D x (M, N); a/d/bias are (K, N)."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.acdc_cascade_ref(x, a, d, bias, c, ct, ct_mid, relu)
    if x.device.type != "cuda":
        raise ValueError(f"acdc_cascade: unsupported device {x.device}")
    y = launch_cascade(x, a, d, bias, c, ct, ct_mid, relu)
    launches += 1
    return y
