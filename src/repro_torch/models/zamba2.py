"""Zamba2-style hybrid: a Mamba2 backbone plus ONE shared attention block
(port of :mod:`repro.models.zamba2`; arXiv:2411.15242).

A single transformer block's parameters are reused after every
``attn_every`` mamba layers (Zamba's parameter sharing).  The shared
block sees the concatenation of the current hidden state and the
original embedding, folded through a 2d -> d input projection (SELL role
``shared_in``).  Each application keeps its own K/V: the dense cache
holds ``attn_k``/``attn_v`` (n_apps, B, Smax, Hkv, Dh), the paged one
``attn_k_pages``/``attn_v_pages`` (n_apps, n_blocks, bs, Hkv, Dh); the
SSM and conv states stay dense in both (they are O(1) a slot).

Under tensor parallelism (``tp``, a placed train, prefill or decode
step's :class:`repro_torch.dist.sharding.TensorSplit`) the mamba layers
compute this rank's SSM heads (:mod:`repro_torch.models.mamba2`), the shared
block its attention heads and ffn columns as a decoder layer does (its
``in_proj`` whole: its output is the residual stream), and the
embedding and logits this rank's block of the vocabulary.

The K/V writes SET their rows, in place (the port's attention; see
:mod:`repro_torch.models.attention`).  The SSM/conv state is updated in
place by the decode steps and snapshotted by the verify steps, whose
returned cache holds new state tensors.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.models import attention as attn_mod
from repro_torch.models import linear
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (
    ModelConfig,
    cross_entropy,
    embed_init,
    embed_lookup,
    init_rms_norm,
    leaf_split,
    rms_norm,
    stack_init,
    unembed,
)
from repro_torch.models.transformer import keep, layer_params


def _n_groups(cfg: ModelConfig) -> List[int]:
    """Mamba layers before each shared-block application."""
    k = cfg.attn_every
    full, rem = divmod(cfg.n_layers, k)
    return [k] * full + ([rem] if rem else [])


def init(gen: torch.Generator, cfg: ModelConfig,
         device=DEFAULT_DEVICE) -> dict:
    """Random parameters (the reference's shapes and distributions, other
    numbers), the mamba layers made one at a time into their stack."""
    dtype = cfg.param_dtype
    d = cfg.d_model
    embed = embed_init(gen, cfg.vocab_size, d, dtype, device)
    layers = stack_init(
        cfg.n_layers, lambda _: mamba_mod.init_layer(gen, cfg, dtype, device))
    shared = {
        "in_proj": linear.linear_init(gen, 2 * d, d, cfg, "shared_in",
                                      dtype, device),
        "norm1": init_rms_norm(d, dtype, device),
        "attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "norm2": init_rms_norm(d, dtype, device),
        "mlp": mlp_mod.init_mlp(gen, cfg, None, dtype, device),
    }
    return {"embed": embed, "layers": layers, "shared": shared,
            "final_norm": init_rms_norm(d, dtype, device)}


def _shared_in(shared: dict, x: torch.Tensor, emb: torch.Tensor,
               cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, the attention input): the 2d -> d input projection of
    [x, emb] and its pre-attention norm."""
    d = cfg.d_model
    h = linear.linear_apply(shared["in_proj"], torch.cat([x, emb], dim=-1),
                            2 * d, d, cfg, "shared_in")
    return h, rms_norm(h, shared["norm1"]["scale"], cfg.norm_eps)


def _shared_out(shared: dict, x: torch.Tensor, h: torch.Tensor,
                attn_out: torch.Tensor, cfg: ModelConfig,
                tp=None) -> torch.Tensor:
    """The residual attention output, the gated MLP (on this rank's ffn
    columns under ``tp``), and the block's residual onto the mamba
    stream."""
    h = h + attn_out
    m = rms_norm(h, shared["norm2"]["scale"], cfg.norm_eps)
    return x + (h + mlp_mod.mlp(shared["mlp"], m, cfg, tp=tp))


def _shared_block(shared: dict, x: torch.Tensor, emb: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig,
                  tp=None) -> torch.Tensor:
    """One application of the shared block over a whole sequence (full
    causal attention; this rank's heads under ``tp``)."""
    h, a = _shared_in(shared, x, emb, cfg)
    out, _, _ = attn_mod.attention_prefill(shared["attn"], a, positions, 0,
                                           cfg, tp)
    return _shared_out(shared, x, h, out, cfg, tp)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None].expand(b, s)


def apply(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
          frontend_embeds=None, tp=None) -> torch.Tensor:
    """Full-sequence forward -> fp32 logits (B, S, V); ``S`` a multiple
    of ``cfg.ssm_chunk``.  ``frontend_embeds`` is unused.  Under ``tp``
    (see the module's docstring) this rank's block of the vocabulary
    (B, S, V / model) where it splits."""
    del frontend_embeds
    emb = embed_lookup(params["embed"], tokens, cfg.compute_dtype, tp)
    positions = _positions(tokens)
    x, start = emb, 0
    for size in _n_groups(cfg):
        x = mamba_mod.run_layers(params["layers"], x, cfg, start,
                                 start + size, tp)
        x = _shared_block(params["shared"], x, emb, positions, cfg, tp)
        start += size
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x, tp)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            rows=None, tp=None) -> torch.Tensor:
    """Next-token cross-entropy; ``rows`` and ``tp`` as in
    :func:`repro_torch.models.transformer.loss_fn`."""
    logits = apply(params, batch["tokens"], cfg, tp=tp)
    return cross_entropy(logits, batch["labels"], cfg, rows, tp)


# ---------------------------------------------------------------------------
# Prefill: a batched prompt pass filling the SSM states and the shared
# block's K/V.
# ---------------------------------------------------------------------------

def prefill(params: dict, cache: dict, tokens: torch.Tensor,
            cfg: ModelConfig, lengths: Optional[torch.Tensor] = None,
            frontend_embeds=None, cut=keep, split=None, tp=None
            ) -> Tuple[torch.Tensor, dict]:
    """:func:`apply` over right-padded prompts keeping every decode cache:
    each layer's SSM and conv state and each shared-block application's
    K/V (zero at and beyond a row's length) -> (logits (B, S, V), a NEW
    cache shaped like ``cache``); ``cut`` as in
    :func:`repro_torch.models.transformer.prefill`; ``split`` is accepted
    and unused, as in :func:`repro_torch.models.mamba2.prefill`.  Under
    ``tp`` the SSM states and the K/V are this rank's heads where they
    split over "model" and the logits its block of the vocabulary."""
    del frontend_embeds, split
    smax = cache["attn_k"].shape[2]
    lengths, mask = mamba_mod.lengths_mask(tokens, lengths)
    emb = embed_lookup(params["embed"], tokens, cfg.compute_dtype, tp)
    positions = _positions(tokens)
    shared = params["shared"]
    local = mamba_mod.heads_of(tp) is not None
    ssms, convs, ks, vs = [], [], [], []
    x, start = emb, 0
    for size in _n_groups(cfg):
        for i in range(start, start + size):
            layer = layer_params(params["layers"], i)
            h = rms_norm(x, layer["norm"]["scale"], cfg.norm_eps)
            y, ssm, conv = mamba_mod.mamba_block_prefill(
                layer["mixer"], h, cfg, mask, lengths, tp)
            x = x + y
            ssms.append(cut("ssm", ssm, local))
            convs.append(cut("conv", conv))
        h, a = _shared_in(shared, x, emb, cfg)
        out, k, v = attn_mod.attention_prefill(shared["attn"], a, positions,
                                               0, cfg, tp)
        x = _shared_out(shared, x, h, out, cfg, tp)
        ck, cv = attn_mod.scatter_prefill_kv(k, v, lengths, smax)
        kv_local = k.shape[2] < cfg.n_kv_heads
        ks.append(cut("attn_k", ck, kv_local))
        vs.append(cut("attn_v", cv, kv_local))
        start += size
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x, tp), {
        "ssm": torch.stack(ssms).to(cache["ssm"].dtype),
        "conv": torch.stack(convs).to(cache["conv"].dtype),
        "attn_k": torch.stack(ks).to(cache["attn_k"].dtype),
        "attn_v": torch.stack(vs).to(cache["attn_v"].dtype)}


# ---------------------------------------------------------------------------
# Decode and verify: mamba states plus the K/V of each shared-block
# application.
# ---------------------------------------------------------------------------

#: cache leaves that are truly recurrent (cannot rewind): a speculative
#: rollback re-commits them at the accepted length from the snapshots,
#: and the paged decode freezes them on parked (free or stalled) rows
RECURRENT_CACHE_KEYS = mamba_mod.RECURRENT_CACHE_KEYS


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=DEFAULT_DEVICE) -> dict:
    n_apps = len(_n_groups(cfg))
    cache = mamba_mod.init_ssm_cache(cfg, batch, cfg.n_layers,
                                     cfg.compute_dtype, device)
    kv = attn_mod.init_kv_cache(cfg, batch, max_len, n_apps,
                                cfg.compute_dtype, device)
    cache["attn_k"], cache["attn_v"] = kv["k"], kv["v"]
    return cache


def init_cache_paged(cfg: ModelConfig, batch: int, n_blocks: int,
                     block_size: int, device=DEFAULT_DEVICE) -> dict:
    """Pages only the shared attention's K/V (one pool a application):
    the SSM and conv state is O(1) a slot and stays dense."""
    n_apps = len(_n_groups(cfg))
    cache = mamba_mod.init_ssm_cache(cfg, batch, cfg.n_layers,
                                     cfg.compute_dtype, device)
    kv = attn_mod.init_kv_cache_paged(cfg, n_blocks, block_size, n_apps,
                                      cfg.compute_dtype, device)
    cache["attn_k_pages"] = kv["k_pages"]
    cache["attn_v_pages"] = kv["v_pages"]
    return cache


def _step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
          attend: Callable, states: Optional[dict] = None,
          frozen: Optional[torch.Tensor] = None, split=None,
          tp=None) -> torch.Tensor:
    """The decode (T = 1) or verify (T tokens) pass over ``tokens`` (B, T)
    -> logits (B, T, V).  ``attend(app, a)`` runs shared-block application
    ``app`` on its input ``a`` (writing its K/V in place).  With
    ``states`` (:func:`repro_torch.models.mamba2.new_states`) every mamba
    layer snapshots its T + 1 states there and ``cache`` keeps its state;
    without, the state is updated in place, except on the rows where
    ``frozen`` (B,) is set.  ``split`` (a placed decode's
    :class:`repro_torch.dist.sharding.DecodeSplit`) gives the mamba
    layers this rank's heads of the SSM state; ``tp`` (its
    :class:`repro_torch.dist.sharding.TensorSplit`) computes them, the
    shared block's MLP columns (``attend`` its heads) and this rank's
    block of the vocabulary (B, T, V / model) where it splits."""
    ssm_split = leaf_split(split, "ssm")
    emb = embed_lookup(params["embed"], tokens, cfg.compute_dtype, tp)
    shared = params["shared"]
    x, start = emb, 0
    for app, size in enumerate(_n_groups(cfg)):
        for i in range(start, start + size):
            layer = layer_params(params["layers"], i)
            h = rms_norm(x, layer["norm"]["scale"], cfg.norm_eps)
            if states is not None:
                out, _, _ = mamba_mod.mamba_block_verify(
                    layer["mixer"], h, cache["ssm"][i], cache["conv"][i],
                    cfg, states["ssm"][i], states["conv"][i])
            else:
                out, ssm, conv = mamba_mod.mamba_block_decode(
                    layer["mixer"], h, cache["ssm"][i], cache["conv"][i],
                    cfg, ssm_split, tp)
                if frozen is not None:
                    ssm = torch.where(frozen[:, None, None, None],
                                      cache["ssm"][i], ssm)
                    conv = torch.where(frozen[:, None, None],
                                       cache["conv"][i], conv)
                cache["ssm"][i] = ssm
                cache["conv"][i] = conv
            x = x + out
        h, a = _shared_in(shared, x, emb, cfg)
        x = _shared_out(shared, x, h, attend(app, a), cfg, tp)
        start += size
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x, tp)


def _dense_attend(params, cache, position, cfg, split=None, tp=None):
    kv_split = leaf_split(split, "attn_k")

    def attend(app, a):
        out, _, _ = attn_mod.attention_verify(
            params["shared"]["attn"], a, cache["attn_k"][app],
            cache["attn_v"][app], position, 0, cfg, kv_split, tp)
        return out
    return attend


def _paged_attend(params, cache, position, block_tables, cfg):
    def attend(app, a):
        out, _, _ = attn_mod.attention_verify_paged(
            params["shared"]["attn"], a, cache["attn_k_pages"][app],
            cache["attn_v_pages"][app], block_tables, position, 0, cfg)
        return out
    return attend


def _verified(cache: dict, states: dict) -> dict:
    """The cache after all T tokens: the KV leaves (written in place) and
    the last snapshot of each recurrent leaf."""
    out = dict(cache)
    for key in RECURRENT_CACHE_KEYS:
        out[key] = states[key][:, :, -1]
    return out


def verify_step(params: dict, cache: dict, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, dict, dict]:
    """Speculative append-and-score: the shared attention's K/V
    set-written at ``position + i`` (a rollback is a position rewind), the
    mamba SSM/conv state snapshotted per position in ``states`` for the
    accepted-length commit -> (logits (B, T, V), cache after all T
    tokens, states)."""
    states = mamba_mod.new_states(cfg, cache, tokens.shape[1])
    logits = _step(params, cache, tokens, cfg,
                   _dense_attend(params, cache, position, cfg), states)
    return logits, _verified(cache, states), states


def verify_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      position: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict, dict]:
    """Paged twin of :func:`verify_step`: the K/V set-scattered through
    the block table, the snapshots as dense."""
    states = mamba_mod.new_states(cfg, cache, tokens.shape[1])
    logits = _step(params, cache, tokens, cfg,
                   _paged_attend(params, cache, position, block_tables, cfg),
                   states)
    return logits, _verified(cache, states), states


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig, split=None,
                tp=None) -> Tuple[torch.Tensor, dict]:
    """One decode step -> (logits (B, V), cache updated in place);
    ``split`` (a :class:`repro_torch.dist.sharding.DecodeSplit`) and
    ``tp`` (the model-local view's
    :class:`repro_torch.dist.sharding.TensorSplit`) are a placed
    decode's: the mamba layers compute this rank's SSM heads, the shared
    block its attention heads on its block of each application's K/V
    (:func:`repro_torch.models.attention.attention_verify`) and its ffn
    columns (its ``in_proj`` whole), and the logits are this rank's block
    of the vocabulary where it splits."""
    logits = _step(params, cache, tokens[:, None], cfg,
                   _dense_attend(params, cache, position, cfg, split, tp),
                   split=split, tp=tp)
    return logits[:, 0], cache


def decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      position: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step against the paged pools (updated in place).  Rows
    parked at or beyond the virtual row length (free slots, and slots the
    engine stalled because the pool ran dry) FREEZE their SSM/conv state:
    a stalled slot's pending token is issued again once the stall clears,
    and the recurrence, unlike the K/V write (routed to the trash page),
    would otherwise consume it twice."""
    bs = cache["attn_k_pages"].shape[2]
    frozen = position >= block_tables.shape[1] * bs
    logits = _step(params, cache, tokens[:, None], cfg,
                   _paged_attend(params, cache, position, block_tables, cfg),
                   frozen=frozen)
    return logits[:, 0], cache
