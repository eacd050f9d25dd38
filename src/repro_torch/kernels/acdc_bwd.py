"""Single ACDC layer backward (the paper's eqs. 10-14) — wrapper of
``csrc/acdc_bwd.cu``.

Port of :mod:`repro.kernels.acdc_bwd` (``acdc_bwd_pallas``): for x, g
(M, N) with N <= ``KERNEL_MAX_N`` it returns ``(dx, da, dd, db)``, dx in
x's dtype and the (N,) diagonal grads in fp32 (callers cast to the
parameter dtype), ``db`` None when ``with_bias`` is False.  ``h2`` is
recomputed, never stored by the forward.  Larger N takes the two-call
backward of :mod:`repro_torch.kernels.ops` on ``scaled_matmul``.

The kernel writes per-block partial sums to a workspace and a second
pass sums them in block order (no float atomics: identical bits run to
run).

For a CUDA tensor :func:`acdc_bwd` launches the kernel (or raises); for a
CPU tensor it takes :func:`repro_torch.kernels.ref.acdc_bwd_ref`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

#: largest N the kernel takes (two (BM, N) fp32 row blocks in shared
#: memory, BM = 16 at N = 1024), the reference's ``MAX_FUSED_N``
KERNEL_MAX_N = 1024

#: kernel launches since the last reset (plain int; chip_smoke resets it)
launches = 0

_ARGS = [build.VP] * 9 + [build.I32] * 4 + [build.VP]
_DTYPES = (torch.float32, torch.bfloat16)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
              Optional[torch.Tensor]]


def _check(x: torch.Tensor, g: torch.Tensor, mats, vecs) -> None:
    m, n = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"acdc_bwd: x dtype {x.dtype} not in {_DTYPES}")
    if n > KERNEL_MAX_N:
        raise ValueError(f"acdc_bwd kernel takes N <= {KERNEL_MAX_N}, "
                         f"got {n}")
    for t, shape in [(g, (m, n))] + [(t, (n, n)) for t in mats] \
            + [(t, (n,)) for t in vecs]:
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"acdc_bwd: operand {tuple(t.shape)} on "
                             f"{t.device}, want {shape} on {x.device}")


def acdc_bwd(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
             d: torch.Tensor, c: torch.Tensor, ct: torch.Tensor, *,
             with_bias: bool = True) -> Grads:
    """Backward of one fused layer over 2-D x, g (M, N); a, d are (N,)."""
    global launches
    if x.dim() != 2 or g.shape != x.shape:
        raise ValueError(f"x, g must be 2-D of one shape, got "
                         f"{tuple(x.shape)}, {tuple(g.shape)}")
    if x.device.type == "cpu":
        return ref.acdc_bwd_ref(x, g, a, d, c, ct, with_bias)
    if x.device.type != "cuda":
        raise ValueError(f"acdc_bwd: unsupported device {x.device}")
    _check(x, g, (c, ct), (a, d))
    m, n = x.shape
    x = x.contiguous()
    g = g.to(x.dtype).contiguous()
    a, d, c, ct = (t.float().contiguous() for t in (a, d, c, ct))
    rows = build.bind("acdc_bwd", "acdc_bwd_rows_per_block", [build.I32])(n)
    part = torch.empty((-(-m // rows), 3, n), dtype=torch.float32,
                       device=x.device)
    out = torch.zeros((3, n), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    fn = build.bind("acdc_bwd", "acdc_bwd_launch", _ARGS)
    err = fn(x.data_ptr(), g.data_ptr(), a.data_ptr(), d.data_ptr(),
             c.data_ptr(), ct.data_ptr(), dx.data_ptr(), part.data_ptr(),
             out.data_ptr(), m, n, int(with_bias),
             int(x.dtype == torch.bfloat16), build.stream_of(x.device))
    build.check(err, "acdc_bwd")
    launches += 1
    return dx, out[0], out[1], out[2] if with_bias else None
