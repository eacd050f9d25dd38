"""Serving step builders (port of the serving half of
:mod:`repro.dist.steps`): prefill (dense and paged), the decode step
with on-device sampling, and the dense slot insert.

PyTorch runs eagerly, so a "step" is a plain closure over (model, cfg);
there is nothing to compile.  Caches are updated in place.  The training
step, the verify step and the sharding rules wait (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.serving import sampler as sampler_mod


def _last_logits(logits: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    idx = torch.clamp_min(lengths.long() - 1, 0)
    return logits[torch.arange(logits.shape[0], device=logits.device), idx]


def make_prefill_step(model, cfg, paged: bool = False) -> Callable:
    """``step(params, cache, tokens, lengths) -> (logits, new_cache)``.

    Runs the model over right-padded prompts and returns the logits at
    each row's last real token (B, V) plus a new dense cache shaped like
    ``cache``.

    ``paged=True`` builds the paged admission step instead:
    ``step(params, cache, template, tokens, lengths, phys_blocks) ->
    (last_logits, cache)`` runs the batch-1 prefill into a slab shaped
    like ``template`` and scatters it IN PLACE into the pools through
    ``phys_blocks`` (the slot's table row, unmapped entries already
    routed to the trash page).
    """
    if model.prefill is None:
        raise ValueError(f"family {cfg.family!r} has no prefill path")

    if paged:
        def paged_step(params, cache, template, tokens, lengths,
                       phys_blocks):
            logits, slot_cache = model.prefill(params, template, tokens,
                                               cfg, lengths)
            for key in ("k", "v"):
                attn_mod.scatter_prefill_pages(cache[f"{key}_pages"],
                                               slot_cache[key], phys_blocks)
            return _last_logits(logits, lengths), cache

        return paged_step

    def step(params, cache, tokens, lengths):
        logits, new_cache = model.prefill(params, cache, tokens, cfg,
                                          lengths)
        return _last_logits(logits, lengths), new_cache

    return step


def make_serve_step(model, cfg, sample: str = "greedy",
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 0.0, paged: bool = False) -> Callable:
    """``step(params, cache, tokens, position, generator) -> (next,
    cache)``, or with ``paged=True`` ``step(params, cache, tokens,
    position, block_tables, generator)``: one decode step and a sample."""
    if sample not in ("greedy", "temp"):
        raise ValueError(f"unknown sampler {sample!r}")

    def _sample(logits, generator: Optional[torch.Generator]):
        return sampler_mod.sample(logits, method=sample,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, generator=generator)

    if paged:
        if model.decode_step_paged is None:
            raise ValueError(
                f"family {cfg.family!r} has no paged decode path")

        def paged_step(params, cache, tokens, position, block_tables,
                       generator=None):
            logits, cache = model.decode_step_paged(
                params, cache, tokens, position, block_tables, cfg)
            return _sample(logits, generator), cache

        return paged_step

    def step(params, cache, tokens, position, generator=None):
        logits, cache = model.decode_step(params, cache, tokens, position,
                                          cfg)
        return _sample(logits, generator), cache

    return step


def make_insert_step() -> Callable:
    """``insert(cache, slot_cache, slot)``: write a batch-1 slot cache
    into batch row ``slot`` of the decode cache, in place."""

    def insert(cache, slot_cache, slot: int):
        for key, leaf in cache.items():
            leaf[:, slot] = slot_cache[key][:, 0].to(leaf.dtype)
        return cache

    return insert
