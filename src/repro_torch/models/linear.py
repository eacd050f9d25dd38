"""Projection factory: dense or SELL per config (port of
:mod:`repro.models.linear`).

A projection whose ``role`` is listed in ``cfg.sell_targets`` (with
``cfg.sell_kind != 'dense'``) is a structured efficient linear layer —
by default an order-K ACDC cascade, lane-aligned to 128 — otherwise a
dense ``x @ w``.

Under tensor parallelism (``tp``, a
:class:`repro_torch.dist.sharding.TensorSplit`) a dense projection may
hold its "model" block, read from its weight's shape: output columns
(``wq``, ``wk``, ``wv``, ``wg``, ``wu``: the caller passes an input whose
gradient sums over "model", ``tp.copy``) or input rows (``wo``, ``wd``:
the partial sums are reduced over "model" here).  A SELL projection is
never split: it runs batch-local on the whole feature dim, as the
reference's ``_batch_local_constraint`` pins it, and an input that
arrives split over "model" (the heads before a SELL ``wo``) is gathered
first.
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


def splits_out(params: dict, n_out: int) -> bool:
    """Whether a dense projection holds a block of its output columns."""
    return "w" in params and params["w"].shape[-1] < n_out


def splits_in(params: dict, n_in: int) -> bool:
    """Whether a dense projection holds a block of its input rows."""
    return "w" in params and params["w"].shape[-2] < n_in


def linear_apply(params: dict, x: torch.Tensor, n_in: int, n_out: int,
                 cfg: ModelConfig, role: str, tp=None,
                 partial: bool = False) -> torch.Tensor:
    """``x @ w`` or the SELL layer.  Under ``tp`` (see the module's
    docstring) a projection on a block of its input rows returns the sum
    over "model" of the blocks' products, or with ``partial`` this
    rank's own, for the caller to reduce with others."""
    if "sell" in params:
        if x.shape[-1] < n_in:
            x = tp.gather(x, -1)
        return sell_mod.structured_linear(params["sell"], x,
                                          _sell_cfg(cfg, n_in, n_out))
    out = torch.matmul(x, params["w"].to(x.dtype))
    if splits_in(params, n_in) and not partial:
        out = tp.reduce(out)
    return out


def linear_param_count(cfg: ModelConfig, role: str, n_in: int,
                       n_out: int) -> int:
    if uses_sell(cfg, role):
        return _sell_cfg(cfg, n_in, n_out).param_count()
    return n_in * n_out
