"""Routing over the kernels, forward and backward (port of
:mod:`repro.kernels.ops`).

* :func:`acdc_fused_op` — one ACDC layer behind an ``autograd.Function``.
  Forward: N <= ``MAX_FUSED_N`` runs the fused kernel (``acdc_fused``);
  larger N runs the reference's two-call path, ``scaled_matmul(x, C,
  pre=a)`` then ``scaled_matmul(h2, C^T, pre=d, bias=bias C^T)``, with h2
  in x's dtype between the calls.  Backward: the fused backward kernel
  (``acdc_bwd``) for N <= ``MAX_FUSED_N``, else the reference's two-call
  backward (``acdc_bwd_two_call``): three fp32 ``scaled_matmul`` launches
  and plain torch reductions, dx cast to x's dtype.
* :func:`acdc_cascade_op` — the order-K cascade: K == 1 goes to
  :func:`acdc_fused_op`; a cascade that passes the reference's fused
  gate (:func:`cascade_fits`) runs the whole-cascade kernel behind a
  cascade-level ``autograd.Function``; anything else runs
  :func:`_cascade_per_layer`, one :func:`acdc_fused_op` per layer with
  the ReLU and the riffle ``y[..., perm]`` applied in x's dtype between
  them (autograd differentiates through it layer by layer).  The fused
  cascade's backward is the reverse-sweep kernel (``acdc_cascade_bwd``)
  when the reference's backward gate passes (:func:`cascade_bwd_fits`),
  else :func:`_cascade_bwd_core`, a per-layer re-walk and backward;
  each decision is counted in ``CASCADE_BWD_DISPATCHES``.
* :func:`paged_attn_route` — the paged-attention dispatch, counted in
  ``PAGED_ATTN_DISPATCHES``.

The routing DECISIONS are the reference's, computed here by the port's
own copy of its arithmetic (``MAX_FUSED_N``, the fused-cascade budget
and the reverse-sweep budget): they decide where bf16 rounding happens,
so the port must take the same branches to produce the same numbers.
The kernels' own tiles are sized from the H100's budgets inside each
kernel.  Diagonal grads come back in fp32 and are cast to the parameter
dtype, as the reference does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import families as families_mod
from repro_torch.kernels import acdc_bwd as bwd_mod
from repro_torch.kernels import acdc_cascade_bwd as cascade_bwd_mod
from repro_torch.kernels import acdc_cascade_fused as cascade_mod
from repro_torch.kernels import acdc_fused as fused_mod
from repro_torch.kernels import paged_attn as paged_attn_mod
from repro_torch.kernels import scaled_matmul as smm_mod

#: the reference's fused-vs-two-call threshold (acdc_fused.py:672): it
#: decides where bf16 rounding happens, so the port keeps the same value
MAX_FUSED_N = 1024

#: the reference's TPU VMEM budget (acdc_cascade_fused.VMEM_BUDGET): both
#: cascade gates below are its arithmetic, not a budget of this card
VMEM_BUDGET = 14 * 1024 * 1024

# The reference's whole-cascade gate (acdc_cascade_fused.py: fits_vmem /
# pick_bm / cascade_vmem_bytes), copied as arithmetic: a cascade fuses
# when the transform matrices, the stacked diagonals and four row tiles
# fit the budget at one of these row blocks.
_REF_ROW_BLOCKS = (256, 128, 64, 32)

#: the reference's reverse-sweep row blocks (acdc_cascade_bwd.py:59)
CANDIDATE_BMS = (256, 128, 64, 32, 16)

#: paged-attention routing decisions: ``kernel`` (CUDA) or ``plain`` (CPU)
PAGED_ATTN_DISPATCHES = {"kernel": 0, "plain": 0}

#: fused-cascade backward routing decisions, one per backward call:
#: ``reverse_sweep`` (the ``acdc_cascade_bwd`` kernel) or
#: ``per_layer_scan`` (:func:`_cascade_bwd_core`)
CASCADE_BWD_DISPATCHES = {"reverse_sweep": 0, "per_layer_scan": 0}


def cascade_fits(n: int, k: int, *, permute: bool, bias: bool) -> bool:
    """The reference's decision whether an order-K cascade at size N runs
    as one fused kernel (True) or layer by layer (False)."""
    if n > MAX_FUSED_N:
        return False
    mats = 3 if permute else 2
    diags = 3 if bias else 2
    return any(4 * (mats * n * n + diags * k * n + 4 * bm * n)
               <= VMEM_BUDGET for bm in _REF_ROW_BLOCKS)


def cascade_bwd_vmem_bytes(n: int, k: int, *, permute: bool, bias: bool,
                           bm: int = 128) -> int:
    """The reference's estimate of the reverse sweep's live VMEM
    (acdc_cascade_bwd.py:cascade_bwd_vmem_bytes): matrices, stacked
    diagonals with their grad accumulators, the (K-1)-deep stash and seven
    row tiles, in fp32."""
    mats = 3 if permute else 2
    diags = 3 if bias else 2
    accs = 2 * diags
    stash = (k - 1) * bm * n
    tiles = 7 * bm * n
    return 4 * (mats * n * n + (diags + accs) * k * n + stash + tiles)


def cascade_bwd_fits(n: int, k: int, *, permute: bool, bias: bool) -> bool:
    """The reference's backward gate (acdc_cascade_bwd.fits_vmem): True
    runs the reverse sweep, False the per-layer backward."""
    if n > MAX_FUSED_N or k < 2:
        return False
    return any(cascade_bwd_vmem_bytes(n, k, permute=permute, bias=bias,
                                      bm=bm) <= VMEM_BUDGET
               for bm in CANDIDATE_BMS)


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
        ct_mid = ct[:, _riffle(family, n, device)].contiguous()
    return c, ct, ct_mid


def _riffle(family: str, n: int, device) -> torch.Tensor:
    return torch.as_tensor(families_mod.get_family(family).riffle(n),
                           dtype=torch.long, device=device)


def _flatten(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]), x.shape


def _layer_fwd(x2: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
               bias: Optional[torch.Tensor], family: str) -> torch.Tensor:
    """One layer's forward over 2-D x: the fused kernel, or two calls."""
    n = x2.shape[-1]
    c, ct, _ = _mats(family, n, x2.device, False)
    if n <= MAX_FUSED_N:
        return fused_mod.acdc_fused(x2, a, d, bias, c, ct)
    h2 = smm_mod.scaled_matmul(x2, c, pre=a)
    bias_t = None
    if bias is not None:
        bias_t = (bias.float() @ ct).to(x2.dtype)
    return smm_mod.scaled_matmul(h2, ct, pre=d, bias=bias_t)


def _layer_bwd(x2: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
               g2: torch.Tensor, with_bias: bool, family: str):
    """One layer's backward over 2-D x, g -> (dx in x's dtype, da, dd, db
    in fp32; db None without bias): the fused backward kernel, or the
    reference's two-call backward above ``MAX_FUSED_N``."""
    n = x2.shape[-1]
    c, ct, _ = _mats(family, n, x2.device, False)
    if n <= MAX_FUSED_N:
        return bwd_mod.acdc_bwd(x2, g2, a, d, c, ct, with_bias=with_bias)
    # gc and dh1 land in device memory once each; the diagonal scalings
    # ride the products and the reductions are plain torch
    xf = x2.float()
    gc = smm_mod.scaled_matmul(g2.float(), c)
    h2 = smm_mod.scaled_matmul(xf, c, pre=a.float())
    dd = torch.sum(h2 * gc, dim=0)
    db = torch.sum(gc, dim=0) if with_bias else None
    dh1 = smm_mod.scaled_matmul(gc, ct, pre=d.float())
    da = torch.sum(xf * dh1, dim=0)
    return (a.float() * dh1).to(x2.dtype), da, dd, db


def _cast_grads(a, d, bias, da, dd, db):
    return (da.to(a.dtype), dd.to(d.dtype),
            None if bias is None else db.to(bias.dtype))


class _Layer(torch.autograd.Function):
    """One ACDC layer; backward = :func:`_layer_bwd` (h2 recomputed)."""

    @staticmethod
    def forward(ctx, x, a, d, bias, family):
        x2, shape = _flatten(x)
        y = _layer_fwd(x2, a, d, bias, family)
        ctx.family = family
        ctx.save_for_backward(x, a, d, bias)
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x, a, d, bias = ctx.saved_tensors
        x2, shape = _flatten(x)
        dx, da, dd, db = _layer_bwd(x2, a, d, g.reshape(x2.shape),
                                    bias is not None, ctx.family)
        return (dx.reshape(shape), *_cast_grads(a, d, bias, da, dd, db),
                None)


def acdc_fused_op(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  family: str = "acdc") -> torch.Tensor:
    """One layer ``y = ((x*a) C * d + bias) C^T`` along the last axis."""
    return _Layer.apply(x, a, d, bias, family)


def _cascade_per_layer(x, a, d, bias, relu, permute, family="acdc"):
    """Layer-by-layer cascade (the reference's per-layer scan)."""
    n = x.shape[-1]
    k = a.shape[0]
    perm = _riffle(family, n, x.device) if permute else None
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


def _cascade_bwd_core(x2, g2, a, d, bias, relu, permute, family):
    """Per-layer backward of a fused cascade (the reference's
    ``_cascade_bwd_core``): re-walk the K-1 interleaved layers in x's dtype
    keeping each layer's input (and pre-ReLU output), then run
    :func:`_layer_bwd` from the last layer down, un-permuting and masking
    the cotangent between layers.  Used when the reverse sweep's budget
    does not fit."""
    n = x2.shape[-1]
    k = a.shape[0]
    with_bias = bias is not None
    perm = _riffle(family, n, x2.device) if permute else None
    inv_perm = torch.argsort(perm) if permute else None

    def b(i):
        return bias[i] if with_bias else None

    hs, zs = [], []
    h = x2
    for i in range(k - 1):
        z = _layer_fwd(h, a[i], d[i], b(i), family)
        hs.append(h)
        zs.append(z)
        h = torch.clamp_min(z, 0) if relu else z
        if perm is not None:
            h = h[:, perm]
    gcur, da_k, dd_k, db_k = _layer_bwd(h, a[k - 1], d[k - 1], g2,
                                        with_bias, family)
    das, dds, dbs = [da_k], [dd_k], [db_k]
    for i in range(k - 2, -1, -1):
        gz = gcur[:, inv_perm] if inv_perm is not None else gcur
        if relu:
            gz = torch.where(zs[i] > 0, gz, torch.zeros_like(gz))
        gcur, da_i, dd_i, db_i = _layer_bwd(hs[i], a[i], d[i], gz,
                                            with_bias, family)
        das.append(da_i)
        dds.append(dd_i)
        dbs.append(db_i)
    db = torch.stack(dbs[::-1]) if with_bias else None
    return gcur, torch.stack(das[::-1]), torch.stack(dds[::-1]), db


class _Cascade(torch.autograd.Function):
    """The fused order-K cascade; backward routed by the reference's gate
    (reverse sweep, else :func:`_cascade_bwd_core`)."""

    @staticmethod
    def forward(ctx, x, a, d, bias, relu, permute, family):
        x2, shape = _flatten(x)
        c, ct, ct_mid = _mats(family, x2.shape[-1], x.device, permute)
        y = cascade_mod.acdc_cascade(x2, a, d, bias, c, ct, ct_mid,
                                     relu=relu)
        ctx.cfg = (relu, permute, family)
        ctx.save_for_backward(x, a, d, bias)
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x, a, d, bias = ctx.saved_tensors
        relu, permute, family = ctx.cfg
        x2, shape = _flatten(x)
        g2 = g.reshape(x2.shape)
        n, k = x2.shape[-1], a.shape[0]
        if cascade_bwd_fits(n, k, permute=permute, bias=bias is not None):
            CASCADE_BWD_DISPATCHES["reverse_sweep"] += 1
            c, ct, ct_mid = _mats(family, n, x.device, permute)
            dx, da, dd, db = cascade_bwd_mod.acdc_cascade_bwd(
                x2, g2, a, d, bias, c, ct, ct_mid, relu=relu)
        else:
            CASCADE_BWD_DISPATCHES["per_layer_scan"] += 1
            dx, da, dd, db = _cascade_bwd_core(x2, g2, a, d, bias, relu,
                                               permute, family)
        return (dx.reshape(shape), *_cast_grads(a, d, bias, da, dd, db),
                None, None, None)


def acdc_cascade_op(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    relu: bool = False, permute: bool = False,
                    family: str = "acdc") -> torch.Tensor:
    """Order-K cascade over stacked (K, N) diagonals (see module doc)."""
    k = a.shape[0]
    if k == 1:
        return acdc_fused_op(x, a[0], d[0],
                             None if bias is None else bias[0],
                             family=family)
    n = x.shape[-1]
    if not cascade_fits(n, k, permute=permute, bias=bias is not None):
        return _cascade_per_layer(x, a, d, bias, relu, permute, family)
    return _Cascade.apply(x, a, d, bias, relu, permute, family)


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
