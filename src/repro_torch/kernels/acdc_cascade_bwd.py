"""Reverse-sweep backward of a whole order-K ACDC cascade — wrapper of
``csrc/acdc_cascade_bwd.cu``, whose K = 1 launch is one layer's backward
(:mod:`repro_torch.kernels.acdc_bwd` calls :func:`launch_bwd` so).

Port of :mod:`repro.kernels.acdc_cascade_bwd` (``acdc_cascade_bwd_pallas``):
one launch re-walks layers 0 .. K-2 stashing each layer input, then runs
eqs. 10-14 from layer K-1 down to 0 with the cotangent kept on chip.  The
ReLU mask is taken in h-space against the stash and the un-permute is a
contraction against ``ct_mid``'s second axis, so no gather runs.

Returns ``(dx, da, dd, db)``: dx in x's dtype, (K, N) fp32 diagonal
grads (callers cast), ``db`` None without bias.  Which cascades come here
is the reference's backward gate, copied as arithmetic in
:mod:`repro_torch.kernels.ops` (``cascade_bwd_fits``).

The launch is cut by :func:`plan_bwd` (pure Python, cached), the way
:func:`repro_torch.kernels.acdc_cascade_fused.plan` cuts the forward:
one thread block cluster per ``bm`` rows, each CTA owning a slice of the
columns.  Workspaces (allocated here, per call, shaped by the plan): the
per-cluster partial sums ``(clusters, 3, K, N)`` fp32, which a second
pass sums pairwise in a fixed shape (no float atomics: identical bits
run to run), and, only where the plan finds no room for the stash's own
columns in shared memory, the stash ``(K-1, M, N)`` fp32.

For a CUDA tensor :func:`acdc_cascade_bwd` launches the kernel (or
raises); for a CPU tensor it takes
:func:`repro_torch.kernels.ref.acdc_cascade_bwd_ref`.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import acdc_cascade_fused as fwd

#: largest N the kernel takes, the reference's ``MAX_FUSED_N``
KERNEL_MAX_N = 1024

#: kernel launches since the last reset (plain int; chip_smoke resets it)
launches = 0

_ARGS = [build.VP] * 12 + [build.I32] * 15 + [build.VP]
_DTYPES = (torch.float32, torch.bfloat16)

#: (dx, da, dd, db): dx in x's dtype, the diagonal grads fp32, db None
#: without bias
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
              Optional[torch.Tensor]]


def smem_floats(bm: int, lw: int, nk: int, kt: int, k: int, riffle: bool,
                resident: bool, stash_smem: bool) -> int:
    """Shared memory of a backward launch, in floats (the source's
    ``smem_bytes`` / 4): three full-row buffers, the own columns of x, gc
    and the stash (or two slots of it), the warps' partials, the column
    sums and the transform slices (ct_mid's also transposed)."""
    own = bm * lw * (2 + (k - 1 if stash_smem else 2))
    return (3 * bm * nk + own + fwd.WARPS * bm * lw + 3 * fwd.WARPS * lw
            + fwd.mats_floats(nk, kt, lw, 3 if riffle else 2, riffle,
                              resident))


@functools.lru_cache(maxsize=1024)
def plan_bwd(m: int, n: int, k: int, riffle: bool,
             vec_ok: bool = True) -> fwd.Plan:
    """The launch of the reverse sweep at x (m, n), K layers: as the
    forward's plan, over 5K - 2 products; the stash's own columns stay in
    shared memory where they fit (``stash_smem``).  K = 1 (one layer's
    backward: three products, no re-walk, no stash) has no mid matrix.
    Pure Python and cached."""
    if not (1 <= n <= KERNEL_MAX_N and m >= 1
            and (k >= 2 or (k == 1 and not riffle))):
        raise ValueError(f"acdc_cascade_bwd: no plan for M={m} N={n} K={k}")
    return fwd.choose(m, n, 5 * k - 2, fwd.vec_width(n, vec_ok),
                      smem_of(k, riffle))


def smem_of(k: int, riffle: bool):
    """The backward's shared memory as ``candidates`` asks for it: the
    stash's own columns on chip where they fit, else in the workspace."""
    def bytes_of(bm, lw, nk, kt, resident):
        for stash_smem in (True, False):
            b = 4 * smem_floats(bm, lw, nk, kt, k, riffle, resident,
                                stash_smem)
            if b <= fwd.SMEM_LIMIT:
                return b, {"stash_smem": stash_smem}
        return None

    return bytes_of


def workspaces(p: fwd.Plan, m: int, n: int, k: int
               ) -> Tuple[Optional[Tuple[int, ...]], Tuple[int, ...]]:
    """Shapes of the fp32 workspaces the kernel writes: the stash
    ``(K-1, M, N)`` (None when it stays in shared memory) and the
    per-cluster partial sums ``(clusters, 3, K, N)``."""
    stash = None if p.stash_smem else (k - 1, m, n)
    return stash, (p.clusters, 3, k, n)


def max_clusters(p: fwd.Plan, m: int, k: int, riffle: bool,
                 strict: bool = True) -> int:
    """How many of the plan's clusters the card holds at once (raises
    when none, unless not ``strict``)."""
    key = (m, p.n, k, int(riffle), *p.args(), int(p.stash_smem),
           p.smem_bytes)
    return fwd.check_schedulable("acdc_cascade_bwd",
                                 "acdc_cascade_bwd_max_clusters", p, key,
                                 strict)


@functools.lru_cache(maxsize=1024)
def _geometry(m: int, n: int, k: int, riffle: bool, vec_ok: bool):
    """(plan, geometry arguments) of a shape, checked schedulable once."""
    p = plan_bwd(m, n, k, riffle, vec_ok)
    max_clusters(p, m, k, riffle)
    return p, (*p.args(), int(p.stash_smem), p.smem_bytes)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    return build.bind("acdc_cascade_bwd", "acdc_cascade_bwd_launch", _ARGS)


def acdc_cascade_bwd(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                     d: torch.Tensor, bias: Optional[torch.Tensor],
                     c: torch.Tensor, ct: torch.Tensor,
                     ct_mid: Optional[torch.Tensor], *,
                     relu: bool = False, p: Optional[fwd.Plan] = None
                     ) -> Grads:
    """Backward of the fused cascade over 2-D x, g (M, N); a, d, bias are
    the stacked (K, N) diagonals, ``ct_mid`` None without the riffle.  The
    launch is ``p`` (``kernels.ops`` passes the autotuned plan), else
    :func:`plan_bwd`'s."""
    global launches
    if x.dim() != 2 or g.shape != x.shape:
        raise ValueError(f"x, g must be 2-D of one shape, got "
                         f"{tuple(x.shape)}, {tuple(g.shape)}")
    k = a.shape[0]
    if k < 2:
        raise ValueError(f"reverse-sweep backward needs K >= 2, got K={k}")
    if x.device.type == "cpu":
        return ref.acdc_cascade_bwd_ref(x, g, a, d, bias, c, ct, ct_mid,
                                        relu)
    if x.device.type != "cuda":
        raise ValueError(f"acdc_cascade_bwd: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"acdc_cascade_bwd: x dtype {x.dtype} not in "
                        f"{_DTYPES}")
    n = x.shape[1]
    if n > KERNEL_MAX_N:
        raise ValueError(f"acdc_cascade_bwd kernel takes N <= "
                         f"{KERNEL_MAX_N}, got {n}")
    for name, t, shape in (("a", a, (k, n)), ("d", d, (k, n)),
                           ("bias", bias, (k, n)), ("c", c, (n, n)),
                           ("ct", ct, (n, n)), ("ct_mid", ct_mid, (n, n))):
        if t is not None and (tuple(t.shape) != shape
                              or t.device != x.device):
            raise ValueError(f"acdc_cascade_bwd: {name} {tuple(t.shape)} on "
                             f"{t.device}, want {shape} on {x.device}")
    y = launch_bwd(x, g, a, d, bias, c, ct, ct_mid, relu, p)
    launches += 1
    return y


def launch_bwd(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
               d: torch.Tensor, bias: Optional[torch.Tensor],
               c: torch.Tensor, ct: torch.Tensor,
               ct_mid: Optional[torch.Tensor], relu: bool,
               p: Optional[fwd.Plan] = None, *,
               with_db: Optional[bool] = None) -> Grads:
    """Launch both kernels with :func:`plan_bwd`'s launch unless ``p`` is
    given (shapes already checked).  The kernels run in fp32: bf16 x and g
    (g rounded to x's dtype first) are widened exactly and dx is rounded
    back once, where the kernel would round it.  db is computed when
    ``with_db`` (default: a bias is given; at K = 1, whose backward never
    reads the bias, the caller says so without one)."""
    if with_db is None:
        with_db = bias is not None
    m, n = x.shape
    k = a.shape[0]
    xf = fwd._f32(x)
    gf = fwd._f32(g.to(x.dtype))
    a, d, c, ct = (fwd._f32(t) for t in (a, d, c, ct))
    bias = None if bias is None else fwd._f32(bias)
    ct_mid = None if ct_mid is None else fwd._f32(ct_mid)
    riffle = ct_mid is not None
    if p is None:
        p, geo = _geometry(m, n, k, riffle, fwd.aligned(c, ct, ct_mid))
    else:
        fwd.check_given(p, m, n, c, ct, ct_mid)
        max_clusters(p, m, k, riffle)
        geo = (*p.args(), int(p.stash_smem), p.smem_bytes)
    dev = x.device
    stash_shape, part_shape = workspaces(p, m, n, k)
    stash = (None if stash_shape is None else
             torch.empty(stash_shape, dtype=torch.float32, device=dev))
    part = torch.empty(part_shape, dtype=torch.float32, device=dev)
    out = torch.empty((3, k, n), dtype=torch.float32, device=dev)
    dx = torch.empty((m, n), dtype=torch.float32, device=dev)
    err = _launch_fn()(
        xf.data_ptr(), gf.data_ptr(), a.data_ptr(), d.data_ptr(),
        build.ptr(bias), c.data_ptr(), ct.data_ptr(), build.ptr(ct_mid),
        dx.data_ptr(), build.ptr(stash), part.data_ptr(), out.data_ptr(), m,
        n, k, int(relu), int(with_db), *geo, build.stream_of(dev))
    build.check(err, f"acdc_cascade_bwd {p}")
    return (dx if x.dtype == torch.float32 else dx.to(x.dtype), out[0],
            out[1], out[2] if with_db else None)
