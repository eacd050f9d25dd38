"""Architecture registry (port of the config half of
:mod:`repro.configs.registry`): the decoder configurations (dense, MoE,
and LLaVA-NeXT's backbone with its stub vision prefix), the SSM
(Mamba2), the hybrid (Zamba2) and the encoder-decoder (Seamless-M4T,
with a stub audio frontend): the reference's ten."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

from repro_torch.core import families as families_mod
from repro_torch.models.common import ModelConfig

ARCHS: Tuple[str, ...] = (
    "deepseek_67b",
    "chatglm3_6b",
    "gemma3_27b",
    "qwen3_1_7b",
    "moonshot_v1_16b_a3b",
    "deepseek_moe_16b",
    "llava_next_34b",
    "mamba2_1_3b",
    "zamba2_1_2b",
    "seamless_m4t_large_v2",
)


def _module(arch: str):
    if arch not in ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def with_sell(cfg: ModelConfig, kind: str, *, method: str = "auto",
              transform: str = "acdc") -> ModelConfig:
    """``cfg`` with its SELL-target projections swapped for ``kind``
    (``dense`` is the no-op baseline); the transform family is validated
    here, at config-build time."""
    if kind == "dense":
        return cfg
    families_mod.get_family(transform)
    return dataclasses.replace(
        cfg, sell_kind=kind, sell_method=method, sell_transform=transform)
