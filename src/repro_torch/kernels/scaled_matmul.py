"""Scaled matmul ``y = ((x * pre) @ w) * post + bias`` — wrapper of
``csrc/scaled_matmul.cu``.

Port of :mod:`repro.kernels.scaled_matmul` (``scaled_matmul_pallas``).
Two calls make the large-N ACDC layer's forward and three fp32 calls its
backward (``ops.acdc_fused_op`` above ``MAX_FUSED_N``).  The output dtype is x's dtype, so at bf16 the
intermediate ``h2`` rounds to bf16 between the two calls, exactly where
the reference rounds it.

For a CUDA tensor :func:`scaled_matmul` launches the kernel (or raises);
for a CPU tensor it takes the plain version
:func:`repro_torch.kernels.ref.scaled_matmul_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: kernel launches since the last reset (plain int; chip_smoke resets it)
launches = 0

_ARGS = [build.VP] * 6 + [build.I32] * 4 + [build.VP]
_DTYPES = (torch.float32, torch.bfloat16)


def _vec(v: Optional[torch.Tensor], n: int, name: str, device):
    if v is None:
        return None
    if v.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got "
                         f"{tuple(v.shape)}")
    if v.device != device:
        raise ValueError(f"{name} on {v.device}, x on {device}")
    return v.float().contiguous()


def scaled_matmul(x: torch.Tensor, w: torch.Tensor,
                  pre: Optional[torch.Tensor] = None,
                  post: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``((x * pre) @ w) * post + bias`` for 2-D x (M, K) and w (K, N);
    fp32 accumulation, output in x's dtype."""
    global launches
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes x={tuple(x.shape)} w={tuple(w.shape)}")
    if x.device.type == "cpu":
        return ref.scaled_matmul_ref(x, w, pre, post, bias)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"scaled_matmul: x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"scaled_matmul: x dtype {x.dtype} not in {_DTYPES}")
    m, k = x.shape
    n = w.shape[1]
    x = x.contiguous()
    w = w.float().contiguous()
    pre = _vec(pre, k, "pre", x.device)
    post = _vec(post, n, "post", x.device)
    bias = _vec(bias, n, "bias", x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = build.bind("scaled_matmul", "smm_launch", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), build.ptr(pre), build.ptr(post),
             build.ptr(bias), y.data_ptr(), m, n, k,
             int(x.dtype == torch.bfloat16), build.stream_of(x.device))
    build.check(err, "scaled_matmul")
    launches += 1
    return y
