"""Model registry (port of :mod:`repro.models`; the ``decoder`` family).

``get_model(cfg)`` returns the uniform functional interface::

    model.init(gen, cfg, device)                -> params
    model.apply(params, tokens, cfg)            -> logits (B, S, V)
    model.init_cache(cfg, batch, max_len, device)
    model.prefill(params, cache, tokens, cfg, lengths)
                                                -> (logits (B,S,V), cache)
    model.decode_step(params, cache, t, pos, cfg)  -> (logits, cache)
    model.init_cache_paged(cfg, batch, n_blocks, block_size, device)
    model.decode_step_paged(params, cache, t, pos, tables, cfg)
                                                -> (logits, cache)

The ssm, hybrid and encdec families, the training loss and the verify
steps are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    init: Callable
    apply: Callable
    init_cache: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    prefill: Optional[Callable] = None
    init_cache_paged: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None
    module: Any = None


_FAMILIES = {"decoder": transformer}


def get_model(cfg: ModelConfig) -> Model:
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; ported: "
            f"{sorted(_FAMILIES)} (ROADMAP.md)")
    return Model(
        init=mod.init,
        apply=mod.apply,
        init_cache=mod.init_cache,
        decode_step=mod.decode_step,
        prefill=mod.prefill,
        init_cache_paged=mod.init_cache_paged,
        decode_step_paged=mod.decode_step_paged,
        module=mod,
    )
