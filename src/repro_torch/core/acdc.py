"""The ACDC structured efficient linear layer (paper sections 3-4).

Port of :mod:`repro.core.acdc`.  One layer computes (row-vector
convention)::

    y = x . A . C . D . C^-1

with learned real diagonals ``A = diag(a)``, ``D = diag(d)`` and ``C``
from the :mod:`repro_torch.core.families` registry.  ``acdc_cascade``
stacks K such layers (Definition 1) with optional ReLU and riffle
interleavings; ``acdc_rectangular`` pads/truncates for ``N_in != N_out``.

Only ``method="pallas"`` is ported: it routes to the hand-written kernels
through :mod:`repro_torch.kernels.ops` (CUDA on the card, their plain
versions on the CPU).  The ``fft``/``matmul``/``auto`` methods wait
(ROADMAP.md).  Parameters are plain dicts of tensors with a leading K
axis, keyed like the reference pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import families as families_mod

Method = Literal["auto", "fft", "matmul", "pallas"]


def _require_pallas(method: str) -> None:
    if method != "pallas":
        raise NotImplementedError(
            f"method={method!r} is not ported yet; only 'pallas' (the "
            "hand-written kernels) is — see ROADMAP.md")


def acdc(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
         bias: Optional[torch.Tensor] = None, *, method: Method = "pallas",
         family: str = "acdc") -> torch.Tensor:
    """One layer ``y = ((x*a) C * d + bias) C^-1`` along the last axis."""
    n = x.shape[-1]
    if a.shape[-1] != n or d.shape[-1] != n:
        raise ValueError(
            f"diagonal size mismatch: x={n} a={tuple(a.shape)} "
            f"d={tuple(d.shape)}")
    families_mod.get_family(family)
    _require_pallas(method)
    from repro_torch.kernels import ops

    # fp32 master diagonals go to the kernel uncast, as in the reference
    return ops.acdc_fused_op(x, a, d, bias, family=family)


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
    """Apply the order-K cascade with optional ReLU + riffle interleaving."""
    _require_pallas(cfg.method)
    from repro_torch.kernels import ops

    return ops.acdc_cascade_op(
        x, params["a"], params["d"], params.get("bias"),
        relu=cfg.relu, permute=cfg.permute, family=cfg.family)


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
