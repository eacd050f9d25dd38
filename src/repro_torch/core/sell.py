"""Structured Efficient Linear Layer (SELL) dispatch.

Port of :mod:`repro.core.sell`.  :func:`structured_linear` applies the
configured SELL ``x (..., n_in) -> y (..., n_out)`` in the row-vector
convention, for every kind of the reference:

* ``dense``     -- ``y = x W (+ b)``;
* ``low_rank``  -- ``y = x U V (+ b)`` with rank r (Sainath et al. 2013);
* ``circulant`` -- adaptive circulant (Cheng et al. 2015),
  ``y = x diag(a) R`` with R circulant (learned first column ``c``),
  an rFFT product in fp32;
* ``fastfood``  -- Adaptive Fastfood (Yang et al. 2015),
  ``Phi = D1 H P D2 H D3`` with the ``hadamard`` family's transform and a
  fixed permutation derived from the size;
* ``acdc``      -- the paper's order-K cascade
  (:mod:`repro_torch.core.acdc`, any method and transform family);
* ``afdf``      -- the complex variant of section 3 (theory oracle; its
  output is complex).

Every kind also takes parameters with a leading group axis (the MoE
experts' stacks) applied to x of shape ``(G, ..., n_in)``, as the
reference's ``jax.vmap`` over the experts applies them.

Parameters are keyed like the reference's (``w``/``b``, ``u``/``v``,
``a``/``c``, ``d1``-``d3``, ``a``/``d``/``bias``,
``a_re``/``a_im``/``d_re``/``d_im``), so ``bridge.to_torch`` carries them
across unchanged; fresh ones are drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import acdc as acdc_mod
from repro_torch.core import families as families_mod
from repro_torch.core import transforms

SellKind = Literal["dense", "low_rank", "circulant", "fastfood", "acdc",
                   "afdf"]


@dataclasses.dataclass(frozen=True)
class SellConfig:
    """Config for one structured linear ``n_in -> n_out`` (same fields and
    defaults as the reference)."""

    kind: SellKind = "dense"
    n_in: int = 0
    n_out: int = 0
    k: int = 1
    relu: bool = False
    permute: bool = False
    bias: bool = True
    init_std: float = 0.061
    method: acdc_mod.Method = "auto"
    transform: str = "acdc"
    rank: int = 0
    dense_init_scale: float = 1.0
    lane_multiple: int = 1

    @property
    def n_op(self) -> int:
        """Internal (padded square) operating size for transform SELLs."""
        if self.kind == "fastfood":
            n = max(self.n_in, self.n_out)
            return families_mod.get_family("hadamard").valid_size(n)
        n = acdc_mod.rectangular_size(self.n_in, self.n_out,
                                      self.lane_multiple)
        if self.kind == "acdc":
            n = families_mod.get_family(self.transform).valid_size(n)
        return n

    def param_count(self) -> int:
        n, ni, no = self.n_op, self.n_in, self.n_out
        if self.kind == "dense":
            return ni * no + (no if self.bias else 0)
        if self.kind == "low_rank":
            return self.rank * (ni + no) + (no if self.bias else 0)
        if self.kind == "circulant":
            return 2 * n + (no if self.bias else 0)
        if self.kind == "fastfood":
            return 3 * n + (no if self.bias else 0)
        if self.kind == "acdc":
            per = 2 * n + (n if self.bias else 0)
            return per * self.k
        if self.kind == "afdf":
            return 4 * n * self.k
        raise ValueError(self.kind)


def _acdc_cfg(cfg: SellConfig) -> acdc_mod.ACDCConfig:
    return acdc_mod.ACDCConfig(
        n=cfg.n_op, k=cfg.k, relu=cfg.relu, permute=cfg.permute,
        bias=cfg.bias, init_std=cfg.init_std, method=cfg.method,
        family=cfg.transform)


def _fastfood_perm(n: int) -> np.ndarray:
    """Fastfood's fixed permutation P, derived from the size (not a
    parameter), exactly as the reference draws it."""
    return np.random.RandomState(n).permutation(n)


def init_sell_params(gen: torch.Generator, cfg: SellConfig,
                     dtype=torch.float32, device=DEFAULT_DEVICE) -> dict:
    """Fresh parameters of ``cfg``'s kind, drawn from ``gen`` on
    ``device`` (the reference's shapes and distributions)."""
    n = cfg.n_op

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    def with_bias(p):
        if cfg.bias:
            p["b"] = torch.zeros((cfg.n_out,), dtype=dtype, device=device)
        return p

    if cfg.kind == "dense":
        scale = cfg.dense_init_scale / np.sqrt(cfg.n_in)
        return with_bias({"w": scale * randn(cfg.n_in, cfg.n_out)})
    if cfg.kind == "low_rank":
        su = 1.0 / np.sqrt(cfg.n_in)
        sv = 1.0 / np.sqrt(max(cfg.rank, 1))
        return with_bias({"u": su * randn(cfg.n_in, cfg.rank),
                          "v": sv * randn(cfg.rank, cfg.n_out)})
    if cfg.kind == "circulant":
        # a ~ identity + noise; the circulant's first column ~ delta +
        # noise, so the layer starts near identity
        a = 1.0 + cfg.init_std * randn(n)
        c = cfg.init_std * randn(n)
        c[0] += 1.0
        return with_bias({"a": a, "c": c})
    if cfg.kind == "fastfood":
        return with_bias({f"d{i}": 1.0 + cfg.init_std * randn(n)
                          for i in (1, 2, 3)})
    if cfg.kind == "acdc":
        return acdc_mod.init_acdc_params(gen, _acdc_cfg(cfg), dtype, device)
    if cfg.kind == "afdf":
        # complex diagonals stored as separate real/imag parts
        a_re = 1.0 + cfg.init_std * randn(cfg.k, n)
        d_re = 1.0 + cfg.init_std * randn(cfg.k, n)
        a_im = cfg.init_std * randn(cfg.k, n)
        d_im = cfg.init_std * randn(cfg.k, n)
        return {"a_re": a_re, "a_im": a_im, "d_re": d_re, "d_im": d_im}
    raise ValueError(cfg.kind)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = n - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def structured_linear(params: dict, x: torch.Tensor,
                      cfg: SellConfig) -> torch.Tensor:
    """Apply the configured SELL: ``x (..., n_in) -> y (..., n_out)``;
    grouped parameters (a leading G axis) take x (G, ..., n_in)."""
    def vec(name):   # a (n,) parameter, or a grouped (G, n) one, against x
        return acdc_mod.per_group(params[name], x)

    if cfg.kind == "acdc":
        return acdc_mod.acdc_rectangular(params, x, _acdc_cfg(cfg),
                                         cfg.n_in, cfg.n_out)
    if cfg.kind == "afdf":
        hc = _pad_to(x, cfg.n_op).to(torch.complex64)
        for i in range(cfg.k):
            a = torch.complex(params["a_re"][..., i, :],
                              params["a_im"][..., i, :])
            d = torch.complex(params["d_re"][..., i, :],
                              params["d_im"][..., i, :])
            a = acdc_mod.per_group(a.to(torch.complex64), hc)
            d = acdc_mod.per_group(d.to(torch.complex64), hc)
            hc = torch.fft.ifft(torch.fft.fft(hc * a, dim=-1) * d, dim=-1)
        return hc[..., :cfg.n_out]
    if cfg.kind == "dense":
        y = torch.matmul(x, params["w"].to(x.dtype))
    elif cfg.kind == "low_rank":
        y = torch.matmul(torch.matmul(x, params["u"].to(x.dtype)),
                         params["v"].to(x.dtype))
    elif cfg.kind == "circulant":
        n = cfg.n_op
        wd = transforms.work_dtype(x.dtype)
        h = _pad_to(x, n) * vec("a").to(x.dtype)
        hf = torch.fft.rfft(h.to(wd), dim=-1)
        cf = torch.fft.rfft(vec("c").to(wd), dim=-1)
        y = torch.fft.irfft(hf * cf, n=n, dim=-1).to(x.dtype)[..., :cfg.n_out]
    elif cfg.kind == "fastfood":
        n = cfg.n_op
        had = families_mod.get_family("hadamard")
        perm = transforms.constant(_fastfood_perm, n, torch.long, x.device)
        h = _pad_to(x, n) * vec("d3").to(x.dtype)
        h = had.apply(h) * vec("d2").to(x.dtype)
        h = had.apply(torch.index_select(h, -1, perm))
        y = (h * vec("d1").to(x.dtype))[..., :cfg.n_out]
    else:
        raise ValueError(cfg.kind)
    if cfg.bias:
        y = y + vec("b").to(x.dtype)
    return y


def sell_dense_equivalent(params: dict, cfg: SellConfig) -> torch.Tensor:
    """Materialize any *linear* SELL as an explicit (n_in, n_out) matrix
    (fp32 identity rows pushed through :func:`structured_linear`)."""
    if cfg.relu:
        raise ValueError("dense equivalent undefined with ReLU")
    dev = next(iter(params.values())).device
    eye = torch.eye(cfg.n_in, dtype=torch.float32, device=dev)
    return structured_linear(params, eye, cfg)
