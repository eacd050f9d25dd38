"""Reverse-sweep backward of a whole order-K ACDC cascade — wrapper of
``csrc/acdc_cascade_bwd.cu``.

Port of :mod:`repro.kernels.acdc_cascade_bwd` (``acdc_cascade_bwd_pallas``):
one launch re-walks layers 0 .. K-2 stashing each layer input, then runs
eqs. 10-14 from layer K-1 down to 0 with the cotangent kept on chip.  The
ReLU mask is taken in h-space against the stash and the un-permute is a
contraction against ``ct_mid``'s second axis, so no gather runs.

Returns ``(dx, da, dd, db)``: dx in x's dtype, (K, N) fp32 diagonal
grads (callers cast), ``db`` None without bias.  Which cascades come here
is the reference's backward gate, copied as arithmetic in
:mod:`repro_torch.kernels.ops` (``cascade_bwd_fits``).

Workspaces (allocated here, per call): the stash, ``4 (K-1) M N`` bytes,
and the per-block partial sums, ``12 K N`` bytes a block, which a second
pass sums in block order (no float atomics: identical bits run to run).

For a CUDA tensor :func:`acdc_cascade_bwd` launches the kernel (or
raises); for a CPU tensor it takes
:func:`repro_torch.kernels.ref.acdc_cascade_bwd_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.acdc_bwd import Grads

#: largest N the kernel takes (two (BM, N) fp32 row blocks in shared
#: memory, BM = 16 at N = 1024), the reference's ``MAX_FUSED_N``
KERNEL_MAX_N = 1024

#: kernel launches since the last reset (plain int; chip_smoke resets it)
launches = 0

_ARGS = [build.VP] * 12 + [build.I32] * 5 + [build.VP]
_DTYPES = (torch.float32, torch.bfloat16)


def acdc_cascade_bwd(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                     d: torch.Tensor, bias: Optional[torch.Tensor],
                     c: torch.Tensor, ct: torch.Tensor,
                     ct_mid: Optional[torch.Tensor], *,
                     relu: bool = False) -> Grads:
    """Backward of the fused cascade over 2-D x, g (M, N); a, d, bias are
    the stacked (K, N) diagonals, ``ct_mid`` None without the riffle."""
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
    m, n = x.shape
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
    x = x.contiguous()
    g = g.to(x.dtype).contiguous()
    a, d, c, ct = (t.float().contiguous() for t in (a, d, c, ct))
    bias = None if bias is None else bias.float().contiguous()
    ct_mid = None if ct_mid is None else ct_mid.float().contiguous()
    rows = build.bind("acdc_cascade_bwd", "acdc_cascade_bwd_rows_per_block",
                      [build.I32])(n)
    dev = x.device
    stash = torch.empty((k - 1, m, n), dtype=torch.float32, device=dev)
    part = torch.empty((-(-m // rows), 3, k, n), dtype=torch.float32,
                       device=dev)
    out = torch.zeros((3, k, n), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    fn = build.bind("acdc_cascade_bwd", "acdc_cascade_bwd_launch", _ARGS)
    err = fn(x.data_ptr(), g.data_ptr(), a.data_ptr(), d.data_ptr(),
             build.ptr(bias), c.data_ptr(), ct.data_ptr(), build.ptr(ct_mid),
             dx.data_ptr(), stash.data_ptr(), part.data_ptr(),
             out.data_ptr(), m, n, k, int(relu),
             int(x.dtype == torch.bfloat16), build.stream_of(dev))
    build.check(err, "acdc_cascade_bwd")
    launches += 1
    return dx, out[0], out[1], out[2] if bias is not None else None
