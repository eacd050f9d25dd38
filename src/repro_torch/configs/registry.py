"""Architecture registry and the dry run's (arch x shape) cells (port of
:mod:`repro.configs.registry`): the decoder configurations (dense, MoE,
and LLaVA-NeXT's backbone with its stub vision prefix), the SSM
(Mamba2), the hybrid (Zamba2) and the encoder-decoder (Seamless-M4T,
with a stub audio frontend): the reference's ten.

Each architecture has the four LM shape cells:

    train_4k     seq 4096,   global_batch 256   (train step)
    prefill_32k  seq 32768,  global_batch 32    (prefill forward)
    decode_32k   cache 32768, global_batch 128  (serve step, 1 new token)
    long_500k    cache 524288, global_batch 1   (serve step; sub-quadratic
                                                 archs only, see skips())

``input_specs`` returns ``meta`` tensors for every model input of a
cell's step: shapes and dtypes, no storage.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

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


#: the reference's order of ``ARCHS``: the order of :func:`cells`
CELL_ARCHS: Tuple[str, ...] = (
    "deepseek_67b",
    "chatglm3_6b",
    "gemma3_27b",
    "qwen3_1_7b",
    "seamless_m4t_large_v2",
    "mamba2_1_3b",
    "moonshot_v1_16b_a3b",
    "deepseek_moe_16b",
    "zamba2_1_2b",
    "llava_next_34b",
)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

#: archs whose attention is sub-quadratic (SSM / hybrid / 5:1 sliding
#: window) run long_500k; pure full-attention archs skip it
LONG_CONTEXT_OK = {"mamba2_1_3b", "zamba2_1_2b", "gemma3_27b"}


def get_shape(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def skips(arch: str, shape: str) -> Optional[str]:
    """Reason string if this (arch, shape) cell is skipped, else None."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return ("pure full-attention config: 524k-token quadratic attention "
                "is out of contract; run on SSM/hybrid/sliding-window archs")
    return None


def cells(include_skipped: bool = False):
    """The (arch, shape name) cells in the reference's order."""
    return [(a, s.name) for a in CELL_ARCHS for s in SHAPES
            if include_skipped or skips(a, s.name) is None]


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


# ---------------------------------------------------------------------------
# input_specs: meta stand-ins for the dry run.
# ---------------------------------------------------------------------------

def _frontend_tokens(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.frontend == "audio":
        return max(seq_len // 4, 8)      # ~4x temporal downsampling stub
    if cfg.frontend == "vision":
        return cfg.n_frontend_tokens or 576
    return 0


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict:
    """Inputs of the step kind of this cell, as ``meta`` tensors:

    train   -> {"batch": {tokens, labels[, frontend_embeds]}}
    prefill -> {"tokens" [, "frontend_embeds"]}
    decode  -> {"tokens", "position"} (the cache comes from init_cache)
    """
    b, s = shape.global_batch, shape.seq_len
    f = _frontend_tokens(cfg, s)

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        batch = {"tokens": meta((b, s), torch.int32),
                 "labels": meta((b, s), torch.int32)}
        if f:
            batch["frontend_embeds"] = meta((b, f, cfg.d_model),
                                            torch.float32)
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": meta((b, s), torch.int32)}
        if f:
            out["frontend_embeds"] = meta((b, f, cfg.d_model), torch.float32)
        return out
    if shape.kind == "decode":
        return {"tokens": meta((b,), torch.int32),
                "position": meta((b,), torch.int32)}
    raise ValueError(shape.kind)
