"""Single ACDC layer backward (the paper's eqs. 10-14) — the K = 1 launch
of ``csrc/acdc_cascade_bwd.cu``.

Port of :mod:`repro.kernels.acdc_bwd` (``acdc_bwd_pallas``): for x, g
(M, N) with N <= ``KERNEL_MAX_N`` it returns ``(dx, da, dd, db)``, dx in
x's dtype and the (N,) diagonal grads in fp32 (callers cast to the
parameter dtype), ``db`` None when ``with_bias`` is False.  ``h2`` is
recomputed, never stored by the forward.  Larger N takes the two-call
backward of :mod:`repro_torch.kernels.ops` on ``scaled_matmul``.

One layer's backward is the reverse sweep of a one-layer cascade: gc =
g C, h2 = (x a) C, dh1 = (gc d) C^T, three products and no re-walk.  So
the wrapper launches the cluster kernel of
:mod:`repro_torch.kernels.acdc_cascade_bwd` at K = 1 (its plan,
:func:`plan`; the per-cluster partial sums reduced in a fixed order, no
float atomics: identical bits run to run), under its own launch count,
as :mod:`repro_torch.kernels.acdc_fused` launches the forward cascade
kernel at K = 1.

For a CUDA tensor :func:`acdc_bwd` launches the kernel (or raises); for a
CPU tensor it takes :func:`repro_torch.kernels.ref.acdc_bwd_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import acdc_cascade_bwd as cascade_bwd_mod
from repro_torch.kernels import acdc_cascade_fused as fwd
from repro_torch.kernels import ref
from repro_torch.kernels.acdc_cascade_bwd import Grads

#: largest N the kernel takes, the reference's ``MAX_FUSED_N``
KERNEL_MAX_N = cascade_bwd_mod.KERNEL_MAX_N

#: kernel launches since the last reset (plain int; chip_smoke resets it)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)


def plan(m: int, n: int) -> fwd.Plan:
    """The cluster launch of one layer's backward at x (m, n)."""
    return cascade_bwd_mod.plan_bwd(m, n, 1, False)


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
             with_bias: bool = True, p: Optional[fwd.Plan] = None) -> Grads:
    """Backward of one fused layer over 2-D x, g (M, N); a, d are (N,).
    The launch is ``p`` (``kernels.ops`` passes the autotuned plan), else
    :func:`plan`'s."""
    global launches
    if x.dim() != 2 or g.shape != x.shape:
        raise ValueError(f"x, g must be 2-D of one shape, got "
                         f"{tuple(x.shape)}, {tuple(g.shape)}")
    if x.device.type == "cpu":
        return ref.acdc_bwd_ref(x, g, a, d, c, ct, with_bias)
    if x.device.type != "cuda":
        raise ValueError(f"acdc_bwd: unsupported device {x.device}")
    _check(x, g, (c, ct), (a, d))
    dx, da, dd, db = cascade_bwd_mod.launch_bwd(
        x, g, a.reshape(1, -1), d.reshape(1, -1), None, c, ct, None, False,
        p, with_db=with_bias)
    launches += 1
    return dx, da[0], dd[0], None if db is None else db[0]
