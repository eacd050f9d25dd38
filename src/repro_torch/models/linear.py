"""Projection factory: dense or SELL per config (port of
:mod:`repro.models.linear`).

A projection whose ``role`` is listed in ``cfg.sell_targets`` (with
``cfg.sell_kind != 'dense'``) is a structured efficient linear layer —
by default an order-K ACDC cascade, lane-aligned to 128 — otherwise a
dense ``x @ w``.  Single-device port: the reference's batch-sharding
constraint has nothing to constrain here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import sell as sell_mod
from repro_torch.models.common import ModelConfig


def _sell_cfg(cfg: ModelConfig, n_in: int, n_out: int) -> sell_mod.SellConfig:
    return sell_mod.SellConfig(
        kind=cfg.sell_kind,
        n_in=n_in,
        n_out=n_out,
        k=cfg.sell_k,
        relu=cfg.sell_relu,
        permute=cfg.sell_permute,
        bias=False,  # LM convention: norms carry the biases
        init_std=cfg.sell_init_std,
        rank=cfg.sell_rank,
        method=cfg.sell_method,  # type: ignore[arg-type]
        transform=cfg.sell_transform,
        lane_multiple=128,
    )


def uses_sell(cfg: ModelConfig, role: str) -> bool:
    return cfg.sell_kind != "dense" and any(
        role.startswith(t) or t == role for t in cfg.sell_targets)


def linear_init(gen: torch.Generator, n_in: int, n_out: int,
                cfg: ModelConfig, role: str, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> dict:
    if uses_sell(cfg, role):
        scfg = _sell_cfg(cfg, n_in, n_out)
        return {"sell": sell_mod.init_sell_params(gen, scfg, dtype, device)}
    scale = 1.0 / np.sqrt(n_in)
    return {"w": scale * torch.randn((n_in, n_out), generator=gen,
                                     dtype=dtype, device=device)}


def linear_apply(params: dict, x: torch.Tensor, n_in: int, n_out: int,
                 cfg: ModelConfig, role: str) -> torch.Tensor:
    if "sell" in params:
        return sell_mod.structured_linear(params["sell"], x,
                                          _sell_cfg(cfg, n_in, n_out))
    return torch.matmul(x, params["w"].to(x.dtype))



def linear_param_count(cfg: ModelConfig, role: str, n_in: int,
                       n_out: int) -> int:
    if uses_sell(cfg, role):
        return _sell_cfg(cfg, n_in, n_out).param_count()
    return n_in * n_out
