"""Scaled matmul ``y = ((x * pre) @ w) * post + bias`` — wrapper of
``csrc/scaled_matmul.cu``.

Port of :mod:`repro.kernels.scaled_matmul` (``scaled_matmul_pallas``).
Two calls make the large-N ACDC layer's forward and three fp32 calls its
backward (``ops.acdc_fused_op`` above ``MAX_FUSED_N``).  The output dtype is x's dtype, so at bf16 the
intermediate ``h2`` rounds to bf16 between the two calls, exactly where
the reference rounds it.

The kernel has two regimes (the source's header says why), and
:func:`plan` chooses between them and sizes the launch from the shapes
alone: a split-K weight stream for small M (decode) and a 3xTF32
tensor-core GEMM for larger M (prefill, training).  :func:`tf32_split`
is the written form of the tensor-core regime's arithmetic.

Groups (the MoE experts' cascades): pre ``(G, K)``, post and bias
``(G, N)`` scale x's G groups of ``M / G`` consecutive rows each by their
own vectors, in ONE launch over all ``M`` rows against the one shared w
(the reference's ``vmap`` over its ``pallas_call``): :func:`plan` sees
``M = G C``.

For a CUDA tensor :func:`scaled_matmul` launches the kernel (or raises);
for a CPU tensor it takes the plain version
:func:`repro_torch.kernels.ref.scaled_matmul_ref`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

#: calls that launched the kernel since the last reset (one a call, though
#: a call with K splits launches two device kernels; chip_smoke resets it)
launches = 0

_ARGS = [build.VP] * 7 + [build.I32] * 11 + [build.VP]
_DTYPES = (torch.float32, torch.bfloat16)

#: streaming multiprocessors of an H100 SXM
SMS = 132
#: K rows a pipeline stage and a summation slice (``kBK`` in the source)
BK = 32
#: largest M served by the weight stream; above it the tensor cores
#: (chosen from both designs' times at M = 4, 16, 32, 64: PERF.md)
STREAM_MAX_M = 16
#: the weight stream: rows of x a block (``MT``), columns of w a block,
#: and the shared memory its ring takes (``kStreamRing``)
STREAM_ROWS = (4, 8, 16)
STREAM_BN = 128
STREAM_RING_BYTES = 4 * BK * STREAM_BN * 4
#: a block's dynamic shared memory limit on the H100 (227 KB)
SMEM_LIMIT = 232448
#: the tensor-core tiles (bm, bn) and their rate relative to the first,
#: as timed on an H100 (both give each warp 32 x 64 outputs; the 64-row
#: block's 4 warps hide less of the split's latency than the 8 of the
#: 128-row one)
TC_TILES = ((128, 128, 1.0), (64, 128, 0.8))
#: rates of the launch-cost model in :func:`plan_tc`: 3xTF32 fp32-
#: equivalent FLOP/s an SM (49 TFLOP/s over 132 SMs at M = 512 on an H100,
#: PERF.md), device-memory bytes/s, one reduction launch
TC_FLOPS_PER_SM = 0.37e12
HBM_BYTES_S = 3.35e12
REDUCE_S = 3e-6


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of ``csrc/scaled_matmul.cu``: ``regime`` "stream" or
    "tc"; a block covers ``bm`` rows of x and ``bn`` columns of w over one
    of ``splits`` K ranges of ``k_chunk`` rows; ``vec`` is 4 for 16-byte
    copies, 1 for 4-byte ones; ``ws_bytes`` is the fp32 (splits, M, N)
    workspace of the partial sums (0 when ``splits`` is 1)."""
    regime: str
    bm: int
    bn: int
    splits: int
    k_chunk: int
    vec: int
    ws_bytes: int

    def grid(self, m: int, n: int) -> Tuple[int, int, int]:
        return (_cdiv(m, self.bm), _cdiv(n, self.bn), self.splits)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_k(k: int, want: int, max_slices: Optional[int] = None):
    """(splits, k_chunk): about ``want`` K ranges of whole BK slices, at
    most ``max_slices`` slices each, none empty."""
    slices = max(1, _cdiv(k, BK))
    per = _cdiv(slices, max(1, min(want, slices)))
    if max_slices is not None:
        per = min(per, max_slices)
    return _cdiv(slices, per), per * BK


def _itemsize(x_dtype) -> int:
    if x_dtype not in _DTYPES:
        raise TypeError(f"scaled_matmul: x dtype {x_dtype} not in {_DTYPES}")
    return 2 if x_dtype == torch.bfloat16 else 4


def plan_stream(m: int, n: int, k: int, x_dtype, align: int = 16) -> Plan:
    """The weight stream: 128-column strips of w, row groups of at most
    16 rows of x, K split so the grid holds about four blocks an SM."""
    _itemsize(x_dtype)
    bm = next(r for r in STREAM_ROWS if r >= min(m, STREAM_ROWS[-1]))
    blocks = _cdiv(m, bm) * _cdiv(n, STREAM_BN)
    # x * pre of a block's K range sits beside the ring in shared memory
    max_slices = (SMEM_LIMIT - STREAM_RING_BYTES) // (4 * bm * BK)
    splits, kc = _split_k(k, _cdiv(4 * SMS, blocks), max_slices)
    vec = 4 if n % 4 == 0 and align % 16 == 0 else 1
    return Plan("stream", bm, STREAM_BN, splits, kc, vec,
                4 * splits * m * n if splits > 1 else 0)


def plan_tc(m: int, n: int, k: int, x_dtype, align: int = 16) -> Plan:
    """3xTF32 on the tensor cores: the tile and the K splits that a small
    cost model rates fastest -- the SM given the most blocks sets the
    time, plus the partials' round trip through device memory; at least
    8 slices (256 K rows) a split."""
    item = _itemsize(x_dtype)
    slices = max(1, _cdiv(k, BK))
    best = None
    for bm, bn, eff in TC_TILES:
        tiles = _cdiv(m, bm) * _cdiv(n, bn)
        for want in range(1, max(1, slices // 8) + 1):
            splits, kc = _split_k(k, want)
            per_sm = _cdiv(tiles * splits, SMS)
            cost = per_sm * 2.0 * bm * bn * kc / (eff * TC_FLOPS_PER_SM)
            if splits > 1:
                cost += 2 * 4 * splits * m * n / HBM_BYTES_S + REDUCE_S
            if best is None or cost < best[0]:
                best = (cost, bm, bn, splits, kc)
    _, bm, bn, splits, kc = best
    vec = 4 if (n % 4 == 0 and (k * item) % 16 == 0
                and align % 16 == 0) else 1
    return Plan("tc", bm, bn, splits, kc, vec,
                4 * splits * m * n if splits > 1 else 0)


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, x_dtype, align: int = 16) -> Plan:
    """The launch for x (m, k) of ``x_dtype`` and w (k, n); ``align`` is
    the largest power of two (up to 16) dividing both base addresses.
    Pure Python (the CPU tests reach it), and cached: the decode and
    train steps repeat a handful of shapes."""
    if regime(m) == "stream":
        return plan_stream(m, n, k, x_dtype, align)
    return plan_tc(m, n, k, x_dtype, align)


def regime(m: int) -> str:
    """The plan's regime for x with ``m`` rows: ``"stream"`` (the split-K
    weight stream) up to ``STREAM_MAX_M`` rows, else ``"tc"`` (tensor
    cores)."""
    return "stream" if m <= STREAM_MAX_M else "tc"


def tf32_split(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` with ``big = tf32(t)`` and ``small = tf32(t -
    big)``, each rounded to 10 explicit mantissa bits, to nearest with
    ties away from zero (``cvt.rna.tf32.f32``): ``t`` is held to about
    2^-22 of itself by ``big + small``.  The tensor-core regime sums
    ``small @ big + big @ small + big @ big`` in fp32."""
    def tf32(v):
        bits = v.float().contiguous().view(torch.int32)
        mag = (bits & 0x7FFFFFFF) + 0x1000       # half of the dropped 13 bits
        out = (bits & ~0x7FFFFFFF) | (mag & 0x7FFFE000)
        return out.view(torch.float32)

    big = tf32(t)
    return big, tf32(t.float() - big)


def groups_of(m: int, pre: Optional[torch.Tensor],
              post: Optional[torch.Tensor], bias: Optional[torch.Tensor],
              k: int, n: int) -> int:
    """The groups G of a call over x (m, k) and w (k, n): 1 for (k,) /
    (n,) vectors; G for (G, k) / (G, n) ones, which must all be grouped
    alike with G dividing m.  Raises on any other shapes."""
    shapes = [(v, w, name) for v, w, name in ((pre, k, "pre"),
                                             (post, n, "post"),
                                             (bias, n, "bias"))
              if v is not None]
    dims = {v.dim() for v, _, _ in shapes}
    if not shapes or dims == {1}:
        for v, width, name in shapes:
            if v.shape != (width,):
                raise ValueError(f"{name} must have shape ({width},), got "
                                 f"{tuple(v.shape)}")
        return 1
    g = shapes[0][0].shape[0]
    for v, width, name in shapes:
        if v.shape != (g, width):
            raise ValueError(f"grouped {name} must have shape ({g}, "
                             f"{width}) like the others, got "
                             f"{tuple(v.shape)}")
    if g < 1 or m % g:
        raise ValueError(f"{g} groups do not divide x's {m} rows")
    return g


def _vec(v: Optional[torch.Tensor], name: str, device):
    if v is None:
        return None
    if v.device != device:
        raise ValueError(f"{name} on {v.device}, x on {device}")
    return v.float().contiguous()


@functools.lru_cache(maxsize=None)
def _smm_launch():
    return build.bind("scaled_matmul", "smm_launch", _ARGS)


def _align(*ts: torch.Tensor) -> int:
    return math.gcd(16, *(t.data_ptr() for t in ts))


def scaled_matmul(x: torch.Tensor, w: torch.Tensor,
                  pre: Optional[torch.Tensor] = None,
                  post: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``((x * pre) @ w) * post + bias`` for 2-D x (M, K) and w (K, N);
    fp32 accumulation, output in x's dtype.  Vectors (G, K) / (G, N)
    scale x's G groups of M / G rows each (see the module doc)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes x={tuple(x.shape)} w={tuple(w.shape)}")
    if x.device.type == "cpu":
        # the kernel's contract on groups, held for the plain version too
        groups_of(x.shape[0], pre, post, bias, x.shape[1], w.shape[1])
        return ref.scaled_matmul_ref(x, w, pre, post, bias)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"scaled_matmul: x on {x.device}, w on {w.device}")
    x, w = x.contiguous(), w.float().contiguous()
    pre = _vec(pre, "pre", x.device)
    # a grouped pre is staged with x's copies on the tensor cores
    staged = (pre,) if pre is not None and pre.dim() == 2 else ()
    return launch(x, w, pre, post, bias,
                  plan(x.shape[0], w.shape[1], x.shape[1], x.dtype,
                       _align(x, w, *staged)))


def launch(x: torch.Tensor, w: torch.Tensor, pre: Optional[torch.Tensor],
           post: Optional[torch.Tensor], bias: Optional[torch.Tensor],
           p: Plan) -> torch.Tensor:
    """Launch the kernel with plan ``p`` on CUDA tensors (x contiguous,
    w contiguous fp32); raises on anything the plan cannot serve."""
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"scaled_matmul: x on {x.device}, w on {w.device}")
    _itemsize(x.dtype)
    if not (x.is_contiguous() and w.is_contiguous()
            and w.dtype == torch.float32):
        raise ValueError("scaled_matmul: x and fp32 w must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    groups = groups_of(m, pre, post, bias, k, n)
    pre = _vec(pre, "pre", x.device)
    post = _vec(post, "post", x.device)
    bias = _vec(bias, "bias", x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = (torch.empty(p.ws_bytes // 4, dtype=torch.float32, device=x.device)
          if p.splits > 1 else None)
    err = _smm_launch()(x.data_ptr(), w.data_ptr(), build.ptr(pre), build.ptr(post),
             build.ptr(bias), y.data_ptr(), build.ptr(ws), m, n, k,
             int(x.dtype == torch.bfloat16), int(p.regime == "tc"), p.bm,
             p.bn, p.splits, p.k_chunk, int(p.vec == 4), m // groups,
             build.stream_of(x.device))
    build.check(err, f"scaled_matmul {p}")
    launches += 1
    return y
