"""Forward routing over the kernels (port of :mod:`repro.kernels.ops`).

* :func:`acdc_fused_op` — one ACDC layer.  N <= ``MAX_FUSED_N`` runs the
  fused kernel (``acdc_fused``); larger N runs the reference's two-call
  path, ``scaled_matmul(x, C, pre=a)`` then ``scaled_matmul(h2, C^T,
  pre=d, bias=bias C^T)``, with h2 in x's dtype between the calls.
* :func:`acdc_cascade_op` — the order-K cascade: K == 1 goes to
  :func:`acdc_fused_op`; a cascade that passes the reference's fused
  gate (:func:`cascade_fits`) runs the whole-cascade kernel; anything
  else runs :func:`_cascade_per_layer`, one :func:`acdc_fused_op` per
  layer with the ReLU and the riffle ``y[..., perm]`` applied in x's
  dtype between them.
* :func:`paged_attn_route` — the paged-attention dispatch, counted in
  ``PAGED_ATTN_DISPATCHES``.

The routing DECISIONS are the reference's, computed here by the port's
own copy of its arithmetic (``MAX_FUSED_N`` and the cascade budget
test): they decide where bf16 rounding happens, so the port must take
the same branches to produce the same logits.  The kernels' own tiles
are sized from the H100's budgets inside each kernel.

This slice is forward-only: a tensor that requires grad raises (the
backward kernels come with the training slice).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import families as families_mod
from repro_torch.kernels import acdc_cascade_fused as cascade_mod
from repro_torch.kernels import acdc_fused as fused_mod
from repro_torch.kernels import paged_attn as paged_attn_mod
from repro_torch.kernels import scaled_matmul as smm_mod

#: the reference's fused-vs-two-call threshold (acdc_fused.py:672): it
#: decides where bf16 rounding happens, so the port keeps the same value
MAX_FUSED_N = 1024

# The reference's whole-cascade gate (acdc_cascade_fused.py: fits_vmem /
# pick_bm / cascade_vmem_bytes), copied as arithmetic: a cascade fuses
# when the transform matrices, the stacked diagonals and four row tiles
# fit this byte budget at one of these row blocks.
_REF_FUSED_BUDGET = 14 * 1024 * 1024
_REF_ROW_BLOCKS = (256, 128, 64, 32)

#: paged-attention routing decisions: ``kernel`` (CUDA) or ``plain`` (CPU)
PAGED_ATTN_DISPATCHES = {"kernel": 0, "plain": 0}


def cascade_fits(n: int, k: int, *, permute: bool, bias: bool) -> bool:
    """The reference's decision whether an order-K cascade at size N runs
    as one fused kernel (True) or layer by layer (False)."""
    if n > MAX_FUSED_N:
        return False
    mats = 3 if permute else 2
    diags = 3 if bias else 2
    return any(4 * (mats * n * n + diags * k * n + 4 * bm * n)
               <= _REF_FUSED_BUDGET for bm in _REF_ROW_BLOCKS)


@functools.lru_cache(maxsize=32)
def _mats(family: str, n: int, device: torch.device, permute: bool
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The family's fp32 ``(C, C^T, ct_mid)`` at size n on ``device``;
    ``ct_mid = C^T[:, riffle]`` folds the riffle into the mid-cascade
    inverse transform, ``(z @ C^T)[:, p] == z @ C^T[:, p]``."""
    fam = families_mod.get_family(family)
    c, ct = fam.matrices(n, torch.float32, device)
    ct_mid = None
    if permute:
        perm = torch.as_tensor(fam.riffle(n), dtype=torch.long,
                               device=device)
        ct_mid = ct[:, perm].contiguous()
    return c, ct, ct_mid


def _no_grad_inputs(*ts) -> None:
    if any(t is not None and t.requires_grad for t in ts):
        raise NotImplementedError(
            "the port's ACDC ops are forward-only in this slice; backward "
            "kernels come with the training slice (ROADMAP.md)")


def _flatten(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]), x.shape


def acdc_fused_op(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  family: str = "acdc") -> torch.Tensor:
    """One layer ``y = ((x*a) C * d + bias) C^T`` along the last axis."""
    _no_grad_inputs(x, a, d, bias)
    x2, shape = _flatten(x)
    n = x2.shape[-1]
    c, ct, _ = _mats(family, n, x.device, False)
    if n <= MAX_FUSED_N:
        y = fused_mod.acdc_fused(x2, a, d, bias, c, ct)
    else:
        h2 = smm_mod.scaled_matmul(x2, c, pre=a)
        bias_t = None
        if bias is not None:
            bias_t = (bias.float() @ ct).to(x2.dtype)
        y = smm_mod.scaled_matmul(h2, ct, pre=d, bias=bias_t)
    return y.reshape(shape)


def _cascade_per_layer(x, a, d, bias, relu, permute, family="acdc"):
    """Layer-by-layer cascade (the reference's per-layer scan)."""
    n = x.shape[-1]
    k = a.shape[0]
    perm = None
    if permute:
        perm = torch.as_tensor(families_mod.get_family(family).riffle(n),
                               dtype=torch.long, device=x.device)
    h = x
    for i in range(k - 1):
        h = acdc_fused_op(h, a[i], d[i], None if bias is None else bias[i],
                          family=family)
        if relu:
            h = torch.relu(h)
        if perm is not None:
            h = h[..., perm]
    return acdc_fused_op(h, a[k - 1], d[k - 1],
                         None if bias is None else bias[k - 1],
                         family=family)


def acdc_cascade_op(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    relu: bool = False, permute: bool = False,
                    family: str = "acdc") -> torch.Tensor:
    """Order-K cascade over stacked (K, N) diagonals (see module doc)."""
    _no_grad_inputs(x, a, d, bias)
    k = a.shape[0]
    if k == 1:
        return acdc_fused_op(x, a[0], d[0],
                             None if bias is None else bias[0],
                             family=family)
    n = x.shape[-1]
    if not cascade_fits(n, k, permute=permute, bias=bias is not None):
        return _cascade_per_layer(x, a, d, bias, relu, permute, family)
    x2, shape = _flatten(x)
    c, ct, ct_mid = _mats(family, n, x.device, permute)
    y = cascade_mod.acdc_cascade(x2, a, d, bias, c, ct, ct_mid, relu=relu)
    return y.reshape(shape)


def paged_attn_route(hkv: int, dh: int, group: int, t: int,
                     device: torch.device) -> str:
    """``"kernel"`` for CUDA tensors (raising when the kernel cannot take
    the shape: there is no fallback on the card), ``"plain"`` for CPU
    tensors.  Each call counts one decision in ``PAGED_ATTN_DISPATCHES``."""
    if device.type == "cpu":
        route = "plain"
    elif paged_attn_mod.fits(hkv, dh, group, t):
        route = "kernel"
    else:
        raise ValueError(
            f"paged attention kernel cannot take Hkv={hkv} Dh={dh} "
            f"group={group} T={t}")
    PAGED_ATTN_DISPATCHES[route] += 1
    return route
