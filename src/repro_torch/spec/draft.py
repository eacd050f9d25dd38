"""Draft sources: who proposes the k tokens the target model verifies
(port of :mod:`repro.spec.draft`).

Two sources behind one protocol (:class:`DraftSource`):

* :class:`TruncatedCascadeDraft`, the paper's own self-draft: the SAME
  target parameters with every stacked ACDC cascade sliced to its first
  ``depth < K`` layers (sections 3-4: each extra cascade layer refines an
  approximation of the dense projection, so the truncated model is a
  cheap, coarser approximation of the target), optionally also without
  the top ``skip_layers`` transformer blocks.  Riffled cascades
  (``sell_permute=True``) truncate poorly: the dropped tail composes
  near-identity layers WITH their interleaved permutations, so the
  truncated output is roughly a permuted version of the target's.
* :class:`ModelDraft`: any config with the target's vocabulary (fresh or
  supplied parameters).

Engine-side contract: the draft owns a DENSE slot cache mirroring the
engine's slot layout.  Admission prefills its row; each speculative tick
runs k+1 single-token ``verify_step`` calls on it (k sampled drafts plus
one advance step, so the draft's cache covers a fully accepted run);
after verification the engine reports each slot's committed count and
the draft rolls back: its KV by the engine's position rewind (the
propose steps set-write), its recurrent SSM/conv state (the ssm and
hybrid families) by re-committing the snapshot taken after that many
steps.  The reference fuses the k+1 steps into one ``lax.scan``; here
they are a plain loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.dist import steps as steps_mod
from repro_torch.models import get_model
from repro_torch.models.common import ModelConfig
from repro_torch.optim.optimizers import tree_map
from repro_torch.serving import sampler as sampler_mod

#: SELL kinds with a stacked depth axis to truncate ((..., K, N) leaves)
CASCADE_KINDS = ("acdc", "afdf")


class DraftSource(Protocol):
    """What the engine needs from a draft."""

    def prepare(self, n_slots: int, max_len: int, k: int, sample: str,
                temperature: float, top_k: int, top_p: float) -> None: ...

    def prefill(self, slot: int, tokens, lengths,
                frontend_embeds=None) -> None: ...

    def propose(self, tokens, positions, generator): ...

    def commit(self, n_adv) -> None: ...

    def set_k(self, k: int) -> None: ...


def truncate_cascades(params: dict, depth: int) -> dict:
    """Slice every stacked cascade leaf under a ``sell`` subtree to its
    first ``depth`` layers.  Cascade leaves are ``(..., K, N)`` whatever
    the stacking in front (the layer axis), so depth is axis ``-2``."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if key == "sell" and isinstance(val, dict):
                out[key] = {name: leaf[..., :depth, :].contiguous()
                            for name, leaf in val.items()}
            else:
                out[key] = walk(val)
        return out

    return walk(params)


class _EngineDraft:
    """Engine-side machinery shared by every (model, cfg, params) draft."""

    def __init__(self, model, cfg: ModelConfig, params):
        if model.verify_step is None:
            raise ValueError(
                f"family {cfg.family!r} has no verify path to draft with")
        self.model = model
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.rec_keys = tuple(model.recurrent_keys)
        self._rec = None

    # -- engine wiring -----------------------------------------------------

    def prepare(self, n_slots: int, max_len: int, k: int, sample: str,
                temperature: float, top_k: int, top_p: float) -> None:
        self.k = k
        self._sample_args = dict(method=sample, temperature=temperature,
                                 top_k=top_k, top_p=top_p)
        self._cache = self.model.init_cache(self.cfg, n_slots, max_len,
                                            self.device)
        self._template = self.model.init_cache(self.cfg, 1, max_len,
                                               self.device)
        self._prefill = steps_mod.make_prefill_step(self.model, self.cfg)
        self._insert = steps_mod.make_insert_step()

    def set_k(self, k: int) -> None:
        """Re-point the propose loop at a new draft length: the engine's
        degradation ladder steps ``spec_k`` down under load and back up
        after calm.  The slot cache is kept."""
        if k == self.k:
            return
        if k < 1:
            raise ValueError("set_k needs k >= 1; the engine disables "
                             "speculation itself at spec_k_eff=0")
        self.k = k

    @property
    def cache_bytes(self) -> int:
        """Bytes held by the draft's dense slot cache.  A truncated-cascade
        self-draft keeps the target's KV geometry (truncation shrinks
        projections, not heads or layers), so under a paged target it adds
        a dense slab's worth of memory; the engine counts it in its own
        ``cache_bytes``."""
        return sum(t.numel() * t.element_size()
                   for t in self._cache.values())

    def prefill(self, slot: int, tokens: torch.Tensor,
                lengths: torch.Tensor, frontend_embeds=None) -> None:
        """Admission: the draft's own prefill into the slot's row."""
        _, slot_cache = self._prefill(self.params, self._template, tokens,
                                      lengths, frontend_embeds)
        self._cache = self._insert(self._cache, slot_cache, slot)

    def propose(self, tokens: torch.Tensor, positions: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """k drafts a slot: ``(drafts (B, k) int32, draft_logits (B, k, V)
        or None)`` on the draft's device; ``draft_logits`` only for the
        ``temp`` sampler (rejection sampling reads the distribution,
        greedy acceptance only the tokens).  ``tokens`` and ``positions``
        (B,) are each slot's pending token and its position (parked rows
        at or beyond the cache length write nothing)."""
        k, greedy = self.k, self._sample_args["method"] == "greedy"
        tok = tokens
        drafts, lgs = [], []
        # the recurrent leaves after 0 .. k+1 steps (each verify step
        # returns new state tensors, so the earlier ones stay intact)
        self._rec = ([{key: self._cache[key] for key in self.rec_keys}]
                     if self.rec_keys else None)
        # k sampled drafts + ONE advance step feeding the last draft, so a
        # fully accepted run leaves no hole at position p + k
        for i in range(k + 1):
            logits, self._cache, _ = self.model.verify_step(
                self.params, self._cache, tok[:, None], positions + i,
                self.cfg)
            if self._rec is not None:
                self._rec.append({key: self._cache[key]
                                  for key in self.rec_keys})
            if i == k:
                break
            lg = logits[:, 0]
            tok = sampler_mod.sample(lg, generator=generator,
                                     **self._sample_args)
            drafts.append(tok)
            if not greedy:
                lgs.append(lg)
        return (torch.stack(drafts, dim=1),
                None if greedy else torch.stack(lgs, dim=1))

    def commit(self, n_adv) -> None:
        """Roll back to each slot's committed length ``n_adv`` (B,) (host
        ints): the KV by the engine's position rewind, the recurrent state
        by re-committing the propose snapshot after ``n_adv[b]`` steps."""
        if self._rec is None:
            return
        cache = dict(self._cache)
        for key in self.rec_keys:
            leaf = self._rec[0][key]    # the cache before propose: rewrite
            for b, n in enumerate(n_adv):
                if n:
                    leaf[:, b] = self._rec[int(n)][key][:, b]
            cache[key] = leaf
        self._cache = cache
        self._rec = None


class TruncatedCascadeDraft(_EngineDraft):
    """Self-draft: the target's params with each SELL cascade cut to
    ``depth`` layers (and the top ``skip_layers`` blocks dropped)."""

    def __init__(self, cfg: ModelConfig, params, depth: int,
                 skip_layers: int = 0):
        if cfg.sell_kind in CASCADE_KINDS:
            if not 1 <= depth <= cfg.sell_k:
                raise ValueError(
                    f"draft depth {depth} outside [1, {cfg.sell_k}]")
            dcfg = dataclasses.replace(cfg, sell_k=depth)
            dparams = truncate_cascades(params, depth)
            self.depth = depth
        elif skip_layers:
            # no cascades, but dropping top blocks still gives a cheaper
            # draft; depth means nothing here
            dcfg, dparams = cfg, params
            self.depth = None
        else:
            raise ValueError(
                f"sell_kind {cfg.sell_kind!r} has no stacked cascades to "
                "truncate and skip_layers=0: the 'draft' would be the FULL "
                "target model run k+1 extra times per tick (strictly "
                "slower).  Serve an acdc/afdf SELL model, set skip_layers, "
                "or pass an explicit draft (e.g. spec.ModelDraft)")
        if skip_layers:
            if cfg.family != "decoder":
                raise ValueError(
                    "skip_layers only applies to the decoder family")
            keep = cfg.n_layers - skip_layers
            if keep < 1:
                raise ValueError(f"cannot skip {skip_layers} of "
                                 f"{cfg.n_layers} layers")
            dcfg = dataclasses.replace(dcfg, n_layers=keep)
            dparams = {**dparams, "layers": tree_map(
                lambda p: p[:keep], dparams["layers"])}
        self.skip_layers = skip_layers
        super().__init__(get_model(dcfg), dcfg, dparams)


class ModelDraft(_EngineDraft):
    """Draft from any config sharing the target's vocabulary; without
    ``params`` its weights are drawn from ``generator`` (default seed 0)."""

    def __init__(self, cfg: ModelConfig, params=None,
                 generator: Optional[torch.Generator] = None,
                 target_cfg: Optional[ModelConfig] = None,
                 device=DEFAULT_DEVICE):
        if target_cfg is not None and cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab {cfg.vocab_size} != target "
                f"{target_cfg.vocab_size}")
        model = get_model(cfg)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = model.init(generator, cfg, device)
        super().__init__(model, cfg, params)
