"""Model registry (port of :mod:`repro.models`): the ``decoder``,
``encdec`` (Seamless-M4T), ``ssm`` (Mamba2) and ``hybrid`` (Zamba2)
families.

``get_model(cfg)`` returns the uniform functional interface::

    model.init(gen, cfg, device)                -> params
    model.apply(params, tokens, cfg, fe)        -> logits (B, S, V)
    model.loss_fn(params, batch, cfg)           -> scalar loss
    model.init_cache(cfg, batch, max_len, device)
    model.prefill(params, cache, tokens, cfg, lengths, fe)
                                                -> (logits (B,S,V), cache)
    model.decode_step(params, cache, t, pos, cfg)  -> (logits, cache)
    model.init_cache_paged(cfg, batch, n_blocks, block_size, device)
    model.decode_step_paged(params, cache, t, pos, tables, cfg)
                                                -> (logits, cache)
    model.verify_step(params, cache, toks (B,T), pos, cfg)
                                                -> (logits (B,T,V), cache,
                                                    states | None)
    model.verify_step_paged(params, cache, toks, pos, tables, cfg)
                                                -> same, paged KV

The paged pair is None for a family with no length-proportional K/V to
page (mamba2's recurrent state is O(1) a slot).  The verify pair is the
speculative-decoding append-and-score path (K/V set-written, so a
rollback is a position rewind); ``states`` carries per-position
snapshots of the ``recurrent_keys`` cache leaves (mamba2, zamba2), which
cannot rewind and are re-committed at the accepted length instead.
``fe`` is a frontend's embeddings: LLaVA's stub patch prefix, or the
stub audio frames Seamless-M4T's encoder reads (required by its
``apply`` and by the prefill that fills a slot's cross K/V).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.models import encdec, mamba2, transformer, zamba2
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    init: Callable
    apply: Callable
    loss_fn: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    prefill: Optional[Callable] = None
    init_cache_paged: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None
    verify_step: Optional[Callable] = None
    verify_step_paged: Optional[Callable] = None
    #: cache keys whose state is truly recurrent (snapshot rollback)
    recurrent_keys: tuple = ()
    module: Any = None


_FAMILIES = {
    "decoder": transformer,
    "encdec": encdec,
    "ssm": mamba2,
    "hybrid": zamba2,
}


def get_model(cfg: ModelConfig) -> Model:
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; ported: "
            f"{sorted(_FAMILIES)} (ROADMAP.md)")
    return Model(
        init=mod.init,
        apply=mod.apply,
        loss_fn=mod.loss_fn,
        init_cache=getattr(mod, "init_cache", None),
        decode_step=getattr(mod, "decode_step", None),
        prefill=getattr(mod, "prefill", None),
        init_cache_paged=getattr(mod, "init_cache_paged", None),
        decode_step_paged=getattr(mod, "decode_step_paged", None),
        verify_step=getattr(mod, "verify_step", None),
        verify_step_paged=getattr(mod, "verify_step_paged", None),
        recurrent_keys=tuple(getattr(mod, "RECURRENT_CACHE_KEYS", ())),
        module=mod,
    )
