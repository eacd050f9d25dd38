"""Gradient compression: blockwise int8 quantization + error feedback
(port of :mod:`repro.dist.compression`).

* **blockwise int8** — every ``BLOCK`` consecutive values share one fp32
  scale = max|x| / 127; the elementwise error is bounded by scale/2.
* **error feedback** — the quantization residual is carried to the next
  step and added before quantizing (Seide et al. 2014; Karimireddy et al.
  2019): the accumulated TRANSMITTED signal then tracks the true gradient
  sum to within one quantization step instead of drifting O(T).
* **compressed all-reduce** — quantize (grad + error), sum the
  dequantized fp32 values over the data-parallel process group, return
  the new local residual.  As in the reference, the collective carries
  the dequantized fp32 values: the int8 wire format is a transport
  concern the reference leaves open, and so does the port.

The arithmetic is the compiled reference's op for op, so ``q`` and
``scale`` are bitwise what its train step computes: the block scale is
max|x| times fp32(1/127) (XLA turns the reference's division by the
constant 127 into that product; the reference called eagerly divides,
which can differ by one ulp), ``q`` a true division by
``max(scale, 1e-30)``, rounded half to even, clipped to +-127, NaN cast
to 0 as XLA casts it.  Plain PyTorch: the reference has no kernel here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.optim.optimizers import tree_flatten, tree_map, \
    tree_unflatten

BLOCK = 256

#: the reciprocal XLA multiplies by where the reference divides by 127
_INV_127 = 1.0 / 127.0


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten ``x`` and quantize in blocks of ``BLOCK``.

    Returns ``(q, scale)`` with ``q`` int8 of shape (n_blocks, BLOCK) (the
    tail block zero-padded) and ``scale`` fp32 of shape (n_blocks, 1).
    """
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    n_blocks = -(-n // BLOCK)
    pad = n_blocks * BLOCK - n
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(n_blocks, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) * _INV_127
    q = torch.where(scale > 0, blocks / torch.clamp_min(scale, 1e-30), 0.0)
    # a block whose scale is inf quantizes its infs to NaN: XLA casts NaN
    # to 0, torch leaves the cast undefined
    q = torch.nan_to_num(torch.clamp(torch.round(q), -127, 127), nan=0.0)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` -> fp32 of shape (n,)."""
    return (q.float() * scale).reshape(-1)[:n]


def make_error_state(params: dict) -> dict:
    """fp32 zero residuals, one per leaf (error-feedback carry)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_all_reduce(grad: torch.Tensor, error: torch.Tensor,
                          group: Optional[dist.ProcessGroup] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce of one leaf over ``group``.

    Returns ``(summed_dequantized_grad, new_error)``; the caller carries
    ``new_error`` into the next step.  With no group this is the sum over
    one member: (dequantize(quantize(g + e)), quantization residual), the
    invariant ``ghat + new_e == g + e``.
    """
    n = grad.numel()
    flat = grad.float().reshape(-1) + error.reshape(-1)
    # drop non-finite contributions BEFORE quantizing: an inf/NaN would
    # corrupt its block's scale and, through the carry, every later step
    flat = torch.where(torch.isfinite(flat), flat, 0.0)
    q, scale = quantize_int8(flat)
    local = dequantize_int8(q, scale, n)
    new_error = (flat - local).reshape(grad.shape)
    total = local.clone()
    if group is not None:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.reshape(grad.shape).to(grad.dtype), new_error


def compressed_all_reduce_tree(grads: dict, errors: dict,
                               group: Optional[dist.ProcessGroup] = None):
    """Leafwise :func:`compressed_all_reduce` over a gradient tree ->
    (summed grads, new errors), both shaped like ``grads``."""
    paths, leaves = tree_flatten(grads)
    _, errs = tree_flatten(errors)
    out = [compressed_all_reduce(g, e, group) for g, e in zip(leaves, errs)]
    return (tree_unflatten(paths, [o[0] for o in out]),
            tree_unflatten(paths, [o[1] for o in out]))
