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

Grouped cascades (the MoE experts, which the reference runs under
``jax.vmap``): diagonals with a leading group axis, ``(G, N)`` a layer or
``(G, K, N)`` a cascade, over x of shape ``(G, ..., N)``.  Above
``MAX_FUSED_N`` every ``scaled_matmul`` of the two-call layer is ONE
grouped launch over all G groups' rows (per-row diagonals, one shared
C), forward and backward, and the diagonal grads are per-group sums.  At
N <= ``MAX_FUSED_N`` (smoke widths only) the cascade kernels are launched
once per group on that group's rows, forward and backward.

The routing DECISIONS are the reference's, computed here by the port's
own copy of its arithmetic (``MAX_FUSED_N``, the fused-cascade budget
and the reverse-sweep budget): they decide where bf16 rounding happens,
so the port must take the same branches to produce the same numbers.
How the chosen kernel is launched is not a routing decision: each cascade
kernel call takes its plan from :func:`.autotune.autotuned_plan` (swept
on the card at a key's first call, the cost model's off it), as the
reference's dispatches ask ``autotune.autotuned_bm`` for their block.  Diagonal grads come back in fp32 and are cast to the parameter
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
from repro_torch.kernels import autotune
from repro_torch.kernels import paged_attn as paged_attn_mod
from repro_torch.kernels import scaled_matmul as smm_mod
from repro_torch.obs.metrics import REGISTRY, CounterDict

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

#: paged-attention routing decisions: ``kernel`` (CUDA) or ``plain`` (CPU).
#: A dict shim over ``kernel_paged_attn_dispatches_total{route=}`` in the
#: process-global obs registry, so exporters report it beside the engine's
#: metrics
PAGED_ATTN_DISPATCHES = CounterDict(
    REGISTRY.counter("kernel_paged_attn_dispatches_total",
                     "paged-attention routing decisions",
                     labels=("route",)),
    ("kernel", "plain"))

#: fused-cascade backward routing decisions, one per backward call:
#: ``reverse_sweep`` (the ``acdc_cascade_bwd`` kernel) or
#: ``per_layer_scan`` (:func:`_cascade_bwd_core`); registry metric
#: ``kernel_cascade_bwd_dispatches_total{route=}``
CASCADE_BWD_DISPATCHES = CounterDict(
    REGISTRY.counter("kernel_cascade_bwd_dispatches_total",
                     "cascade-backward routing decisions",
                     labels=("route",)),
    ("reverse_sweep", "per_layer_scan"))


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


def _plan(direction: str, x2: torch.Tensor, k: int, bias: bool,
          permute: bool, family: str):
    """The autotuned launch of one cascade kernel call over 2-D x."""
    return autotune.autotuned_plan(
        direction, x2.shape[0], x2.shape[-1], k, device=x2.device,
        dtype=x2.dtype, bias=bias, permute=permute, family=family)


def _flatten(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]), x.shape


def _grouped(a: torch.Tensor, k_axis: bool) -> bool:
    """Whether stacked diagonals carry a leading group axis: ``(G, N)`` a
    layer (``(G, K, N)`` a cascade, ``k_axis``)."""
    return a.dim() == (3 if k_axis else 2)


def _each(v: Optional[torch.Tensor], g: int) -> Optional[torch.Tensor]:
    return None if v is None else v[g]


def _group_rows(x2: torch.Tensor, groups: int):
    """The rows of 2-D x (G C, N), group by group."""
    return x2.reshape(groups, -1, x2.shape[-1]).unbind(0)


def _row_sum(t: torch.Tensor, groups: Optional[int]) -> torch.Tensor:
    """The sum over rows of 2-D t: per group ``(G, N)`` when grouped."""
    if groups is None:
        return torch.sum(t, dim=0)
    return torch.sum(t.reshape(groups, -1, t.shape[-1]), dim=1)


def _layer_fwd(x2: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
               bias: Optional[torch.Tensor], family: str) -> torch.Tensor:
    """One layer's forward over 2-D x: the fused kernel, or two calls
    (grouped diagonals: one grouped launch a call; the fused kernel once
    per group)."""
    n = x2.shape[-1]
    c, ct, _ = _mats(family, n, x2.device, False)
    if n <= MAX_FUSED_N:
        def run(xg, ag, dg, bg):
            return fused_mod.acdc_fused(
                xg, ag, dg, bg, c, ct,
                p=_plan("fwd", xg, 1, bg is not None, False, family))

        if not _grouped(a, False):
            return run(x2, a, d, bias)
        return torch.cat([run(xg, a[g], d[g], _each(bias, g)) for g, xg
                          in enumerate(_group_rows(x2, a.shape[0]))])
    h2 = smm_mod.scaled_matmul(x2, c, pre=a)
    bias_t = None
    if bias is not None:
        bias_t = (bias.float() @ ct).to(x2.dtype)
    return smm_mod.scaled_matmul(h2, ct, pre=d, bias=bias_t)


def _layer_bwd(x2: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
               g2: torch.Tensor, with_bias: bool, family: str):
    """One layer's backward over 2-D x, g -> (dx in x's dtype, da, dd, db
    in fp32; db None without bias): the fused backward kernel, or the
    reference's two-call backward above ``MAX_FUSED_N``.  Grouped
    diagonals give per-group grads ``(G, N)``."""
    n = x2.shape[-1]
    groups = a.shape[0] if _grouped(a, False) else None
    c, ct, _ = _mats(family, n, x2.device, False)
    if n <= MAX_FUSED_N:
        def run(xg, gg, ag, dg):
            return bwd_mod.acdc_bwd(
                xg, gg, ag, dg, c, ct, with_bias=with_bias,
                p=_plan("bwd", xg, 1, with_bias, False, family))

        if groups is None:
            return run(x2, g2, a, d)
        outs = [run(xg, gg, a[g], d[g])
                for g, (xg, gg) in enumerate(zip(_group_rows(x2, groups),
                                                 _group_rows(g2, groups)))]
        dx, da, dd, db = zip(*outs)
        return (torch.cat(dx), torch.stack(da), torch.stack(dd),
                torch.stack(db) if with_bias else None)
    # gc and dh1 land in device memory once each; the diagonal scalings
    # ride the products and the reductions are plain torch
    xf = x2.float()
    gc = smm_mod.scaled_matmul(g2.float(), c)
    h2 = smm_mod.scaled_matmul(xf, c, pre=a.float())
    dd = _row_sum(h2 * gc, groups)
    db = _row_sum(gc, groups) if with_bias else None
    dh1 = smm_mod.scaled_matmul(gc, ct, pre=d.float())
    da = _row_sum(xf * dh1, groups)
    if groups is None:
        dx = a.float() * dh1
    else:
        dx = (dh1.reshape(groups, -1, n) * a.float()[:, None]).reshape(
            dh1.shape)
    return dx.to(x2.dtype), da, dd, db


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
    """One layer ``y = ((x*a) C * d + bias) C^T`` along the last axis;
    diagonals ``(G, N)`` are per group of x (G, ..., N)."""
    return _Layer.apply(x, a, d, bias, family)


def _cascade_per_layer(x, a, d, bias, relu, permute, family="acdc"):
    """Layer-by-layer cascade (the reference's per-layer scan) over (K, N)
    diagonals, or grouped (G, K, N) ones."""
    n = x.shape[-1]
    k = a.shape[-2]
    perm = _riffle(family, n, x.device) if permute else None

    def layer(h, i):
        return acdc_fused_op(h, a[..., i, :], d[..., i, :],
                             None if bias is None else bias[..., i, :],
                             family=family)

    h = x
    for i in range(k - 1):
        h = layer(h, i)
        if relu:
            h = torch.relu(h)
        if perm is not None:
            h = h[..., perm]
    return layer(h, k - 1)


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
    (reverse sweep, else :func:`_cascade_bwd_core`).  Grouped (G, K, N)
    diagonals launch the kernels once per group on its rows."""

    @staticmethod
    def forward(ctx, x, a, d, bias, relu, permute, family):
        x2, shape = _flatten(x)
        c, ct, ct_mid = _mats(family, x2.shape[-1], x.device, permute)

        def run(xg, ag, dg, bg):
            return cascade_mod.acdc_cascade(
                xg, ag, dg, bg, c, ct, ct_mid, relu=relu,
                p=_plan("cascade", xg, ag.shape[0], bg is not None,
                        permute, family))

        if _grouped(a, True):
            y = torch.cat([run(xg, a[g], d[g], _each(bias, g)) for g, xg
                           in enumerate(_group_rows(x2, a.shape[0]))])
        else:
            y = run(x2, a, d, bias)
        ctx.cfg = (relu, permute, family)
        ctx.save_for_backward(x, a, d, bias)
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x, a, d, bias = ctx.saved_tensors
        relu, permute, family = ctx.cfg
        x2, shape = _flatten(x)
        g2 = g.reshape(x2.shape)
        n, k = x2.shape[-1], a.shape[-2]
        if cascade_bwd_fits(n, k, permute=permute, bias=bias is not None):
            CASCADE_BWD_DISPATCHES["reverse_sweep"] += 1
            c, ct, ct_mid = _mats(family, n, x.device, permute)

            def run(xg, gg, ag, dg, bg):
                return cascade_bwd_mod.acdc_cascade_bwd(
                    xg, gg, ag, dg, bg, c, ct, ct_mid, relu=relu,
                    p=_plan("cascade_bwd", xg, ag.shape[0], bg is not None,
                            permute, family))
        else:
            CASCADE_BWD_DISPATCHES["per_layer_scan"] += 1

            def run(xg, gg, ag, dg, bg):
                return _cascade_bwd_core(xg, gg, ag, dg, bg, relu, permute,
                                         family)
        if _grouped(a, True):
            groups = a.shape[0]
            outs = [run(xg, gg, a[i], d[i], _each(bias, i))
                    for i, (xg, gg) in enumerate(zip(
                        _group_rows(x2, groups), _group_rows(g2, groups)))]
            dx, da, dd, db = zip(*outs)
            dx, da, dd = torch.cat(dx), torch.stack(da), torch.stack(dd)
            db = torch.stack(db) if bias is not None else None
        else:
            dx, da, dd, db = run(x2, g2, a, d, bias)
        return (dx.reshape(shape), *_cast_grads(a, d, bias, da, dd, db),
                None, None, None)


def cascade_route(n: int, k: int, *, permute: bool, bias: bool) -> str:
    """How :func:`acdc_cascade_op` runs an order-K cascade at size N
    forward: ``"cascade"`` (one whole-cascade kernel), ``"fused"`` (K
    single-layer kernels) or ``"two_call"`` (2 K ``scaled_matmul``
    calls)."""
    if k > 1 and cascade_fits(n, k, permute=permute, bias=bias):
        return "cascade"
    return "fused" if n <= MAX_FUSED_N else "two_call"


def forward_launches(n: int, k: int, rows: int, *, permute: bool,
                     bias: bool, groups: int = 1) -> dict:
    """The kernel launches, by wrapper, of one :func:`acdc_cascade_op`
    forward over ``rows`` rows on the card (all groups' rows together for
    a grouped cascade of ``groups`` groups), as :func:`cascade_route` and
    ``scaled_matmul``'s regime route it; ``scaled_matmul`` launches are
    also counted under ``scaled_matmul_<regime>``.  A grouped two-call
    cascade launches as an ungrouped one over the same rows; the cascade
    kernels launch once per group."""
    route = cascade_route(n, k, permute=permute, bias=bias)
    if route == "cascade":
        return {"acdc_cascade": groups}
    if route == "fused":
        return {"acdc_fused": k * groups}
    return {"scaled_matmul": 2 * k,
            f"scaled_matmul_{smm_mod.regime(rows)}": 2 * k}


def acdc_cascade_op(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    relu: bool = False, permute: bool = False,
                    family: str = "acdc") -> torch.Tensor:
    """Order-K cascade over stacked (K, N) diagonals, or grouped (G, K, N)
    ones over x (G, ..., N) (see module doc)."""
    k = a.shape[-2]
    route = cascade_route(x.shape[-1], k, permute=permute,
                          bias=bias is not None)
    if route == "cascade":
        return _Cascade.apply(x, a, d, bias, relu, permute, family)
    if k == 1:
        return acdc_fused_op(x, a[..., 0, :], d[..., 0, :],
                             None if bias is None else bias[..., 0, :],
                             family=family)
    return _cascade_per_layer(x, a, d, bias, relu, permute, family)


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
