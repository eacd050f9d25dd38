"""Structured Efficient Linear Layer (SELL) dispatch.

Port of :mod:`repro.core.sell`.  :func:`structured_linear` applies the
configured SELL ``x (..., n_in) -> y (..., n_out)`` in the row-vector
convention.  Ported kinds: ``dense`` and ``acdc`` (the paper's order-K
cascade, :mod:`repro_torch.core.acdc`).  The ``low_rank``, ``circulant``,
``fastfood`` and ``afdf`` baselines raise ``NotImplementedError`` until a
later slice ports them (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import acdc as acdc_mod
from repro_torch.core import families as families_mod

SellKind = Literal["dense", "low_rank", "circulant", "fastfood", "acdc",
                   "afdf"]

_PORTED = ("dense", "acdc")


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"SELL kind {kind!r} is not ported yet; only {_PORTED} are — see "
        "ROADMAP.md")


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


def init_sell_params(gen: torch.Generator, cfg: SellConfig,
                     dtype=torch.float32, device=DEFAULT_DEVICE) -> dict:
    if cfg.kind == "dense":
        scale = cfg.dense_init_scale / np.sqrt(cfg.n_in)
        p = {"w": scale * torch.randn((cfg.n_in, cfg.n_out), generator=gen,
                                      dtype=dtype, device=device)}
        if cfg.bias:
            p["b"] = torch.zeros((cfg.n_out,), dtype=dtype, device=device)
        return p
    if cfg.kind == "acdc":
        return acdc_mod.init_acdc_params(gen, _acdc_cfg(cfg), dtype, device)
    raise _not_ported(cfg.kind)


def structured_linear(params: dict, x: torch.Tensor,
                      cfg: SellConfig) -> torch.Tensor:
    """Apply the configured SELL: ``x (..., n_in) -> y (..., n_out)``."""
    if cfg.kind == "dense":
        y = torch.matmul(x, params["w"].to(x.dtype))
        if cfg.bias:
            y = y + params["b"].to(x.dtype)
        return y
    if cfg.kind == "acdc":
        return acdc_mod.acdc_rectangular(params, x, _acdc_cfg(cfg),
                                         cfg.n_in, cfg.n_out)
    raise _not_ported(cfg.kind)
