"""Train and serve step builders (port of :mod:`repro.dist.steps`): the
train state and train step with gradient accumulation, prefill (dense
and paged), the decode step with on-device sampling, and the dense slot
insert.

PyTorch runs eagerly, so a "step" is a plain closure over (model, cfg,
opt); there is nothing to compile.  Parameters, optimizer moments and
caches are updated in place.  The compressed gradient all-reduce, the
verify step and the sharding rules wait (ROADMAP.md).

Train state layout (the reference's, so checkpoints and
:mod:`repro_torch.bridge` carry it between the packages)::

    {"params": <model params>, "opt": <optimizer state>, "step": int}
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.models import attention as attn_mod
from repro_torch.optim.optimizers import (global_norm, tree_flatten,
                                          tree_map, tree_unflatten)
from repro_torch.serving import sampler as sampler_mod


def init_state(model, cfg, opt, gen: torch.Generator,
               device=DEFAULT_DEVICE) -> dict:
    """Train state: random params from ``gen``, zero moments, step 0."""
    params = model.init(gen, cfg, device)
    return {"params": params, "opt": opt.init(params), "step": 0}


def loss_and_grads(model, cfg, params: dict, batch: dict):
    """(loss, grads) of ``model.loss_fn`` at ``params``: grads a tree
    shaped like ``params`` (zeros for an unused leaf)."""
    paths, leaves = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(paths, grads)


def make_train_step(model, cfg, opt, accum_steps: int = 1) -> Callable:
    """``step(state, batch) -> (state, metrics)`` with metrics ``{loss,
    grad_norm, update_norm}`` (fp32 scalars).

    The parameters and moments of ``state`` are updated IN PLACE (the
    returned state holds the same tensors).  ``accum_steps > 1`` splits
    the global batch into equal micro-batches run one after another
    (live memory: one micro-batch's activations) and returns the mean
    loss and mean grads, summed in fp32 as the reference sums them.
    The gradients of the SELL projections come from the ACDC ops'
    ``autograd.Function``s (:mod:`repro_torch.kernels.ops`).
    """
    def grads_of(params, batch):
        if accum_steps <= 1:
            return loss_and_grads(model, cfg, params, batch)
        b = batch["tokens"].shape[0]
        if b % accum_steps:
            raise ValueError(
                f"global batch {b} not divisible by accum {accum_steps}")
        mb = b // accum_steps
        loss = grads = None
        for i in range(accum_steps):
            micro = {k: t[i * mb:(i + 1) * mb] for k, t in batch.items()}
            l, g = loss_and_grads(model, cfg, params, micro)
            g = tree_map(lambda t: t.float(), g)
            loss = l if loss is None else loss + l
            grads = g if grads is None else tree_map(torch.add, grads, g)
        inv = 1.0 / accum_steps
        return loss * inv, tree_map(lambda t: t * inv, grads)

    def step(state, batch):
        params = state["params"]
        loss, grads = grads_of(params, batch)
        updates, new_opt = opt.update(grads, state["opt"], params,
                                      state["step"])
        with torch.no_grad():
            tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
        metrics = {"loss": loss.float(), "grad_norm": global_norm(grads),
                   "update_norm": global_norm(updates)}
        return ({"params": params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return step


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
