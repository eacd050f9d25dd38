"""The ACDC structured efficient linear layer (paper sections 3-4).

Port of :mod:`repro.core.acdc`.  One layer computes (row-vector
convention)::

    y = x . A . C . D . C^-1

with learned real diagonals ``A = diag(a)``, ``D = diag(d)`` and ``C``
from the :mod:`repro_torch.core.families` registry.  ``acdc_cascade``
stacks K such layers (Definition 1) with optional ReLU and riffle
interleavings; ``acdc_rectangular`` pads/truncates for ``N_in != N_out``.

Four methods, as in the reference: ``pallas`` routes to the
hand-written kernels through :mod:`repro_torch.kernels.ops` (CUDA on the
card, their plain versions on the CPU); ``matmul`` multiplies by the
family's explicit matrices; ``fft`` applies its fast transforms over
``torch.fft``; ``auto`` (the default) resolves to ``matmul`` at N <=
``MATMUL_MAX_N`` and to ``fft`` above, by the reference's rule and
nothing else.  Parameters are plain dicts of tensors with a leading K
axis, keyed like the reference pytree.

Grouped cascades (the MoE experts): parameters with one more leading
axis, ``(G, K, N)``, apply group ``g``'s diagonals to ``x[g]`` for x of
shape ``(G, ..., N)`` -- what the reference's ``jax.vmap`` over the
experts computes, in one call: ``matmul``/``fft`` broadcast the diagonals
over the group axis, ``pallas`` runs grouped kernels
(:mod:`repro_torch.kernels.ops`).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import families as families_mod
from repro_torch.core import transforms

Method = Literal["auto", "fft", "matmul", "pallas"]

#: the reference's crossover (acdc.py:46): ``auto`` takes the explicit
#: matrices at N <= this and the FFT above; a routing decision, so the
#: reference's value
MATMUL_MAX_N = 4096


def per_group(v: Optional[torch.Tensor], x: torch.Tensor
              ) -> Optional[torch.Tensor]:
    """A diagonal as it multiplies x (..., N): ``(N,)`` as it is, a grouped
    ``(G, N)`` shaped ``(G, 1, ..., 1, N)`` against x (G, ..., N)."""
    if v is None or v.dim() == 1:
        return v
    return v.reshape(v.shape[0], *([1] * (x.dim() - 2)), v.shape[-1])


def _resolve_method(n: int, method: Method) -> str:
    if method != "auto":
        return method
    return "matmul" if n <= MATMUL_MAX_N else "fft"


def acdc(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
         bias: Optional[torch.Tensor] = None, *, method: Method = "auto",
         family: str = "acdc") -> torch.Tensor:
    """One layer ``y = ((x*a) C * d + bias) C^-1`` along the last axis.

    ``bias`` (if given) is the paper's bias-on-D: added after the ``D``
    scaling, in the transform domain, before the inverse transform.
    Diagonals ``(G, N)`` are per group of x (G, ..., N)."""
    n = x.shape[-1]
    if a.shape[-1] != n or d.shape[-1] != n:
        raise ValueError(
            f"diagonal size mismatch: x={n} a={tuple(a.shape)} "
            f"d={tuple(d.shape)}")
    fam = families_mod.get_family(family)
    m = _resolve_method(n, method)
    if m == "pallas":
        from repro_torch.kernels import ops

        # fp32 master diagonals go to the kernel uncast, as in the
        # reference
        return ops.acdc_fused_op(x, a, d, bias, family=family)
    if m not in ("fft", "matmul"):
        raise ValueError(f"unknown method {method!r}")
    # the fft/matmul paths carry the activation dtype: fp32 master
    # diagonals are cast down so a bf16 stream stays bf16
    a = per_group(a.to(x.dtype), x)
    d = per_group(d.to(x.dtype), x)
    bias = per_group(bias.to(x.dtype), x) if bias is not None else None
    h1 = x * a
    if m == "matmul":
        h2 = torch.matmul(h1, fam.matrix(n, x.dtype, x.device))
    else:
        h2 = fam.apply(h1)
    h3 = h2 * d
    if bias is not None:
        h3 = h3 + bias
    if m == "matmul":
        return torch.matmul(h3, fam.inverse_matrix(n, x.dtype, x.device))
    return fam.inverse(h3)


@dataclasses.dataclass(frozen=True)
class ACDCConfig:
    """Configuration of an order-K structured-transform cascade."""

    n: int                       # feature size
    k: int = 1                   # number of stacked ACDC layers
    relu: bool = False           # ReLU between layers (not after last)
    permute: bool = False        # riffle-permute between layers
    bias: bool = True            # bias-on-D (paper section 6.2)
    init_mean: float = 1.0       # paper: N(1, sigma^2) "identity + noise"
    init_std: float = 0.061      # paper section 6.2 value
    first_a_identity: bool = False  # Definition 1 convention A_1 = I
    method: Method = "auto"
    family: str = "acdc"         # transform family (core/families.py)

    def param_count(self) -> int:
        per = 2 * self.n + (self.n if self.bias else 0)
        return per * self.k


def init_acdc_params(gen: torch.Generator, cfg: ACDCConfig,
                     dtype=torch.float32, device=DEFAULT_DEVICE) -> dict:
    """Stacked cascade parameters, each leaf with leading dim ``k``."""
    fam = families_mod.get_family(cfg.family)
    a, d = fam.init_diagonals(gen, cfg.k, cfg.n, cfg.init_mean,
                              cfg.init_std, dtype, device)
    if cfg.first_a_identity:
        a[0] = 1.0
    params = {"a": a, "d": d}
    if cfg.bias:
        params["bias"] = torch.zeros((cfg.k, cfg.n), dtype=dtype,
                                     device=device)
    return params


def acdc_cascade(params: dict, x: torch.Tensor,
                 cfg: ACDCConfig) -> torch.Tensor:
    """Apply the order-K cascade with optional ReLU + riffle interleaving.

    ``pallas``: the kernels' routing (:func:`ops.acdc_cascade_op`: one
    whole-cascade kernel where the reference fuses, else layer by layer).
    ``fft``/``matmul``: K = 1 is one :func:`acdc`; otherwise each of the
    first K-1 layers is followed by the ReLU (if set) and then the riffle
    (if set), and the last layer by neither."""
    a, d, bias = params["a"], params["d"], params.get("bias")
    if _resolve_method(cfg.n, cfg.method) == "pallas":
        from repro_torch.kernels import ops

        return ops.acdc_cascade_op(x, a, d, bias, relu=cfg.relu,
                                   permute=cfg.permute, family=cfg.family)

    def layer(h, i):   # layer i of a (K, N) or grouped (G, K, N) stack
        return acdc(h, a[..., i, :], d[..., i, :],
                    None if bias is None else bias[..., i, :],
                    method=cfg.method, family=cfg.family)

    perm = None
    if cfg.permute and cfg.k > 1:
        perm = transforms.constant(families_mod.get_family(cfg.family).riffle,
                                   cfg.n, torch.long, x.device)
    h = x
    for i in range(cfg.k - 1):
        h = layer(h, i)
        if cfg.relu:
            h = torch.relu(h)
        if perm is not None:
            h = torch.index_select(h, -1, perm)
    return layer(h, cfg.k - 1)


def acdc_cascade_dense_equivalent(params: dict,
                                  cfg: ACDCConfig) -> torch.Tensor:
    """Materialize the cascade as an explicit N x N fp32 matrix (test
    oracle); only valid for linear cascades (no ReLU)."""
    if cfg.relu:
        raise ValueError("dense equivalent undefined with interleaved ReLU")
    eye = torch.eye(cfg.n, dtype=torch.float32, device=params["a"].device)
    # push the identity through the cascade: rows transform independently
    return acdc_cascade({k: v.float() for k, v in params.items()}, eye, cfg)


def rectangular_size(n_in: int, n_out: int, multiple: int = 1) -> int:
    """Operating size for a rectangular ACDC: max(in, out) padded to a
    lane multiple."""
    n = max(n_in, n_out)
    return int(np.ceil(n / multiple) * multiple)


def acdc_rectangular(params: dict, x: torch.Tensor, cfg: ACDCConfig,
                     n_in: int, n_out: int) -> torch.Tensor:
    """Apply a cascade as an ``n_in -> n_out`` map via zero-pad/truncate."""
    if x.shape[-1] != n_in:
        raise ValueError(f"expected last dim {n_in}, got {tuple(x.shape)}")
    pad = cfg.n - n_in
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    y = acdc_cascade(params, x, cfg)
    return y[..., :n_out]
