"""Gated MLP (SwiGLU/GeGLU) — port of the dense half of
:mod:`repro.models.mlp`.  The Mixture-of-Experts layers are not ported
yet (ROADMAP.md)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.models import linear
from repro_torch.models.common import ModelConfig


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, dtype=torch.float32,
             device=DEFAULT_DEVICE) -> dict:
    d_ff = d_ff or cfg.d_ff
    return {
        "wg": linear.linear_init(gen, cfg.d_model, d_ff, cfg, "mlp_in",
                                 dtype, device),
        "wu": linear.linear_init(gen, cfg.d_model, d_ff, cfg, "mlp_in",
                                 dtype, device),
        "wd": linear.linear_init(gen, d_ff, cfg.d_model, cfg, "mlp_out",
                                 dtype, device),
    }


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig,
        d_ff: Optional[int] = None) -> torch.Tensor:
    d_ff = d_ff or cfg.d_ff
    g = linear.linear_apply(params["wg"], x, cfg.d_model, d_ff, cfg,
                            "mlp_in")
    u = linear.linear_apply(params["wu"], x, cfg.d_model, d_ff, cfg,
                            "mlp_in")
    h = _act(cfg.mlp_act, g) * u
    return linear.linear_apply(params["wd"], h, d_ff, cfg.d_model, cfg,
                               "mlp_out")
