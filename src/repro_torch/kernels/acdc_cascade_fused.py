"""Whole-cascade ACDC forward — wrapper of ``csrc/acdc_cascade.cu``.

Port of :mod:`repro.kernels.acdc_cascade_fused` (``acdc_cascade_pallas``):
an order-K cascade ``h <- ((h*a_i) C * d_i + b_i) (C^T or ct_mid)`` with
ReLU between layers and the fp32 activation resident on chip, x read once
and y written once.  ``ct_mid = C^T[:, riffle]`` folds the permutation
into the mid-cascade matrix.

Routing (whether a cascade goes here at all) is decided in
:mod:`repro_torch.kernels.ops` with the reference's own arithmetic; the
kernel's row block is sized from the H100's 227 KB of shared memory
(see the source), not from the TPU's VMEM budget.

For a CUDA tensor :func:`acdc_cascade` launches the kernel (or raises);
for a CPU tensor it takes :func:`repro_torch.kernels.ref.acdc_cascade_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: largest N the kernel takes: two (BM, N) fp32 row blocks must fit the
#: 227 KB of shared memory a block may use (BM = 16 at N = 1024)
KERNEL_MAX_N = 1024

#: kernel launches since the last reset (plain int; chip_smoke resets it)
launches = 0

_ARGS = [build.VP] * 8 + [build.I32] * 5 + [build.VP]
_DTYPES = (torch.float32, torch.bfloat16)


def launch_cascade(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   bias: Optional[torch.Tensor], c: torch.Tensor,
                   ct: torch.Tensor, ct_mid: Optional[torch.Tensor],
                   relu: bool) -> torch.Tensor:
    """Validate and launch the CUDA kernel (shared with ``acdc_fused``)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"acdc cascade: x dtype {x.dtype} not in {_DTYPES}")
    m, n = x.shape
    k = a.shape[0]
    if n > KERNEL_MAX_N:
        raise ValueError(f"acdc cascade kernel takes N <= {KERNEL_MAX_N}, "
                         f"got {n}")
    for name, t, shape in (("a", a, (k, n)), ("d", d, (k, n)),
                           ("bias", bias, (k, n)), ("c", c, (n, n)),
                           ("ct", ct, (n, n)), ("ct_mid", ct_mid, (n, n))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"acdc cascade: {name} {tuple(t.shape)} on "
                             f"{t.device}, want {shape} on {x.device}")
    x = x.contiguous()
    a, d, c, ct = (t.float().contiguous() for t in (a, d, c, ct))
    bias = None if bias is None else bias.float().contiguous()
    ct_mid = None if ct_mid is None else ct_mid.float().contiguous()
    y = torch.empty_like(x)
    fn = build.bind("acdc_cascade", "acdc_cascade_launch", _ARGS)
    err = fn(x.data_ptr(), a.data_ptr(), d.data_ptr(), build.ptr(bias),
             c.data_ptr(), ct.data_ptr(), build.ptr(ct_mid), y.data_ptr(),
             m, n, k, int(relu), int(x.dtype == torch.bfloat16),
             build.stream_of(x.device))
    build.check(err, "acdc_cascade")
    return y


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
