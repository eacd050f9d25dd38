"""Single fused ACDC layer ``y = ((x*a) C * d + bias) C^T`` for
N <= ``ops.MAX_FUSED_N``.

Port of :mod:`repro.kernels.acdc_fused` (``acdc_fused_pallas``).  It
launches the cascade kernel of ``csrc/acdc_cascade.cu`` with K=1 and no
mid matrix, under its own wrapper and launch count, so the K=1 and
per-layer branches of ``ops.acdc_fused_op`` are held and counted on
their own.

For a CUDA tensor :func:`acdc_fused` launches the kernel (or raises); for
a CPU tensor it takes the plain version (the K=1 cascade).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import acdc_cascade_fused as cascade_mod
from repro_torch.kernels import ref

#: kernel launches since the last reset (plain int; chip_smoke resets it)
launches = 0


def acdc_fused(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
               bias: Optional[torch.Tensor], c: torch.Tensor,
               ct: torch.Tensor, *,
               p: Optional[cascade_mod.Plan] = None) -> torch.Tensor:
    """One fused layer over 2-D x (M, N); a, d, bias are (N,).  The launch
    is ``p`` (``kernels.ops`` passes the autotuned plan), else the K = 1
    cascade's :func:`~.acdc_cascade_fused.plan`."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    a2, d2 = a.reshape(1, -1), d.reshape(1, -1)
    b2 = None if bias is None else bias.reshape(1, -1)
    if x.device.type == "cpu":
        return ref.acdc_cascade_ref(x, a2, d2, b2, c, ct, None, False)
    if x.device.type != "cuda":
        raise ValueError(f"acdc_fused: unsupported device {x.device}")
    y = cascade_mod.launch_cascade(x, a2, d2, b2, c, ct, None, False, p)
    launches += 1
    return y
