"""Decoder-only transformer LM (port of :mod:`repro.models.transformer`):
the dense decoders (qwen3, deepseek-67b, chatglm3-6b, gemma3-27b), the
MoE ones (deepseek-moe-16b, moonshot-v1-16b-a3b) and llava-next-34b's
backbone, whose first positions a vision frontend's embeddings replace,
by config knobs.

Layer parameters are stacked with a leading L axis, keyed like the
reference pytree (``layers/attn/wo/sell/a`` is ``(L, K, N)``), so
weights cross between the packages one-to-one
(:mod:`repro_torch.bridge`).  The layer loop is a Python loop over views
of the stacked tensors.  With ``cfg.remat`` and grad enabled, each layer
runs under ``torch.utils.checkpoint`` and is recomputed whole in the
backward (the reference's ``nothing_saveable`` policy).  Caches are
updated in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import DEFAULT_DEVICE
from repro_torch.dist.sharding import PlacedStack
from repro_torch.models import attention as attn_mod
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


def layer_params(layers, i: int) -> dict:
    """Views of layer ``i`` of the stacked layer parameters; of a stack
    placed at rest (:class:`repro_torch.dist.sharding.PlacedStack`), layer
    ``i`` gathered from this rank's blocks."""
    if isinstance(layers, PlacedStack):
        return layers.layer(i)
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _layer_at(fn, layers, i: int, *args):
    return fn(layer_params(layers, i), *args)


def run_layer(fn, layers, i: int, *args, remat: bool):
    """``fn(layer_params(layers, i), *args)``.  Under ``remat`` it runs
    under ``torch.utils.checkpoint``, saves only its inputs and is
    recomputed whole in the backward (the reference's
    ``nothing_saveable``); the layer is sliced inside the checkpointed
    function, so a placed layer's gather is recomputed too and no
    gathered layer outlives its own forward or backward."""
    if remat:
        return checkpoint(_layer_at, fn, layers, i, *args,
                          use_reentrant=False, early_stop=False)
    return _layer_at(fn, layers, i, *args)


def init_layer(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> dict:
    p = {
        "norm1": init_rms_norm(cfg.d_model, dtype, device),
        "attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "norm2": init_rms_norm(cfg.d_model, dtype, device),
    }
    if cfg.n_experts > 0:
        p["moe"] = mlp_mod.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_mod.init_mlp(gen, cfg, None, dtype, device)
    return p


def init(gen: torch.Generator, cfg: ModelConfig,
         device=DEFAULT_DEVICE) -> dict:
    """Random parameters (same shapes and distributions as the reference,
    different numbers: the draws come from ``gen``)."""
    dtype = cfg.param_dtype
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    layers = stack_init(cfg.n_layers,
                        lambda _: init_layer(gen, cfg, dtype, device))
    return {"embed": embed, "layers": layers,
            "final_norm": init_rms_norm(cfg.d_model, dtype, device)}


def _ffn(layer: dict, x: torch.Tensor, cfg: ModelConfig,
         rows=None, tp=None) -> torch.Tensor:
    """The residual feed-forward half of a layer: the MLP or the MoE
    (``rows`` a placed step's, :func:`repro_torch.models.mlp.moe`; ``tp``
    its :class:`repro_torch.dist.sharding.TensorSplit`)."""
    h = rms_norm(x, layer["norm2"]["scale"], cfg.norm_eps)
    if "moe" in layer:
        return x + mlp_mod.moe(layer["moe"], h, cfg, rows, tp)
    return x + mlp_mod.mlp(layer["mlp"], h, cfg, tp=tp)


def _layer_fn(layer: dict, x: torch.Tensor, positions: torch.Tensor,
              window: int, cfg: ModelConfig, rows=None, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the full-sequence forward -> (x, aux loss: the MoE
    layer's load-balance loss, else 0).  ``rows`` (a placed train step's
    :class:`repro_torch.dist.sharding.Rows`) makes the MoE's queues and
    its aux loss the whole batch's; ``tp`` computes on "model" blocks."""
    h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
    out, _, _ = attn_mod.attention_prefill(layer["attn"], h, positions,
                                           window, cfg, tp)
    x = x + out
    if "moe" not in layer:
        return _ffn(layer, x, cfg, tp=tp), torch.zeros((), device=x.device)
    h = rms_norm(x, layer["norm2"]["scale"], cfg.norm_eps)
    return (x + mlp_mod.moe(layer["moe"], h, cfg, rows, tp),
            mlp_mod.moe_aux_loss(layer["moe"], h, cfg, rows))


def backbone(params: dict, x: torch.Tensor, positions: torch.Tensor,
             cfg: ModelConfig, rows=None, tp=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked layers and the final norm over x (B, S, D) -> (hidden,
    the layers' mean aux loss).  Under ``cfg.remat`` with grad enabled
    each layer saves only its input and is recomputed whole in the
    backward (no early stop), as the reference's
    ``jax.checkpoint(..., nothing_saveable)``; a placed layer's gather,
    model-local or whole, stays inside the checkpointed layer."""
    windows = cfg.layer_windows()
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i in range(cfg.n_layers):
        x, aux = run_layer(_layer_fn, params["layers"], i, x, positions,
                           int(windows[i]), cfg, rows, tp, remat=remat)
        auxes.append(aux)
    return (rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps),
            torch.mean(torch.stack(auxes)))


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None].expand(b, s)


def embed_with_frontend(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                        frontend_embeds: Optional[torch.Tensor] = None,
                        tp=None) -> torch.Tensor:
    """The embedded tokens (B, S, D) with the first P positions replaced
    by a frontend's embeddings (B, P, D) (LLaVA's stub patch prefix)."""
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype, tp)
    if frontend_embeds is None:
        return x
    p = frontend_embeds.shape[1]
    return torch.cat([frontend_embeds.to(x.dtype), x[:, p:]], dim=1)


def apply(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
          frontend_embeds: Optional[torch.Tensor] = None,
          tp=None) -> torch.Tensor:
    """Full-sequence forward -> fp32 logits (B, S, V); under ``tp`` (the
    model-local view's :class:`repro_torch.dist.sharding.TensorSplit`)
    this rank's block of the vocabulary (B, S, V / model)."""
    x = embed_with_frontend(params, tokens, cfg, frontend_embeds, tp)
    x, _ = backbone(params, x, _positions(tokens), cfg, tp=tp)
    return unembed(params["embed"], x, tp)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, rows=None,
            tp=None) -> torch.Tensor:
    """Next-token cross-entropy over ``batch["tokens"]`` (B, S) against
    ``batch["labels"]``; positions with label < 0 are masked.  MoE
    configs add ``0.01`` times the layers' mean load-balance loss.  A
    ``batch["frontend_embeds"]`` (B, P, D) replaces the first P embedded
    positions (the pipeline masks their labels for a vision prefix).
    ``rows`` (a placed train step's
    :class:`repro_torch.dist.sharding.Rows`): ``batch`` is this rank's
    rows and the loss the whole batch's (the masked mean and the aux
    loss over every row), each rank's gradient its rows' share; ``tp``
    computes on "model" blocks."""
    tokens = batch["tokens"]
    x = embed_with_frontend(params, tokens, cfg,
                            batch.get("frontend_embeds"), tp)
    x, aux = backbone(params, x, _positions(tokens), cfg, rows, tp)
    logits = unembed(params["embed"], x, tp)
    loss = cross_entropy(logits, batch["labels"], cfg, rows, tp)
    if cfg.n_experts > 0:
        loss = loss + 0.01 * aux
    return loss


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=DEFAULT_DEVICE) -> dict:
    return attn_mod.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                  cfg.compute_dtype, device)


def init_cache_paged(cfg: ModelConfig, batch: int, n_blocks: int,
                     block_size: int, device=DEFAULT_DEVICE) -> dict:
    """One global page pool shared by all slots (``batch`` unused)."""
    del batch
    return attn_mod.init_kv_cache_paged(cfg, n_blocks, block_size,
                                        cfg.n_layers, cfg.compute_dtype,
                                        device)


def keep(name: str, layer: torch.Tensor,
         heads_local: bool = False) -> torch.Tensor:
    """A prefill's default ``cut``: each layer's new cache leaf whole."""
    del name, heads_local
    return layer


def prefill(params: dict, cache: dict, tokens: torch.Tensor,
            cfg: ModelConfig, lengths: Optional[torch.Tensor] = None,
            frontend_embeds: Optional[torch.Tensor] = None, cut=keep,
            split=None, tp=None) -> Tuple[torch.Tensor, dict]:
    """Forward over right-padded prompts -> (logits (B, S, V), a NEW
    cache shaped like ``cache`` holding each row's prompt K/V, zero at
    and beyond its length); ``frontend_embeds`` as in :func:`apply`.
    ``cut(name, layer, heads_local)`` takes each layer's new leaf as it
    is made (a placed prefill keeps this rank's block:
    :class:`repro_torch.dist.sharding.LayerCut`); ``cache`` is read for
    its shapes and dtypes only.  ``split`` (a placed prefill's
    :class:`repro_torch.dist.sharding.DecodeSplit`) gives an MoE layer
    the batch's rows split over ranks.  ``tp`` (the model-local view's
    :class:`repro_torch.dist.sharding.TensorSplit`): each layer computes
    on "model" blocks, the new K/V are this rank's KV heads where they
    split over "model", and the logits this rank's block of the
    vocabulary (B, S, V / model)."""
    rows = None if split is None else split.rows
    b, s = tokens.shape
    smax = cache["k"].shape[2]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32,
                             device=tokens.device)
    x = embed_with_frontend(params, tokens, cfg, frontend_embeds, tp)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    windows = cfg.layer_windows()
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
        out, k, v = attn_mod.attention_prefill(layer["attn"], h, positions,
                                               int(windows[i]), cfg, tp)
        x = _ffn(layer, x + out, cfg, rows, tp)
        ck, cv = attn_mod.scatter_prefill_kv(k, v, lengths, smax)
        local = k.shape[2] < cfg.n_kv_heads
        ks.append(cut("k", ck, local))
        vs.append(cut("v", cv, local))
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(params["embed"], x, tp)
    return logits, {"k": torch.stack(ks).to(cache["k"].dtype),
                    "v": torch.stack(vs).to(cache["v"].dtype)}


def verify_step(params: dict, cache: dict, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig, split=None,
                tp=None) -> Tuple[torch.Tensor, dict, None]:
    """Speculative append-and-score: tokens (B, T) at positions
    ``position .. position + T - 1`` in one pass -> (logits (B, T, V),
    cache set-written in place, None).  Logits at ``i`` score the token
    after ``tokens[:, i]``, as ``decode_step`` fed one token at a time
    would; the KV cache needs no state selection (trailing ``None``).
    ``split`` (a :class:`repro_torch.dist.sharding.DecodeSplit`) and
    ``tp`` (the model-local view's
    :class:`repro_torch.dist.sharding.TensorSplit`) are a placed
    decode's: each layer computes on its "model" blocks and attends this
    rank's block of the cache
    (:func:`repro_torch.models.attention.attention_verify`), an MoE
    layer queues the whole batch's tokens, and the logits are this
    rank's block of the vocabulary (B, T, V / model) where it splits."""
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype, tp)
    windows = cfg.layer_windows()
    kv_split = leaf_split(split, "k")
    rows = None if split is None else split.rows
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
        out, _, _ = attn_mod.attention_verify(
            layer["attn"], h, cache["k"][i], cache["v"][i], position,
            int(windows[i]), cfg, kv_split, tp)
        x = _ffn(layer, x + out, cfg, rows, tp)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x, tp), cache, None


def verify_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      position: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict, None]:
    """Paged twin of :func:`verify_step` (writes through the block table,
    attends with the paged-attention kernel at T = tokens.shape[1])."""
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    windows = cfg.layer_windows()
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
        out, _, _ = attn_mod.attention_verify_paged(
            layer["attn"], h, cache["k_pages"][i], cache["v_pages"][i],
            block_tables, position, int(windows[i]), cfg)
        x = _ffn(layer, x + out, cfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x), cache, None


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig, split=None,
                tp=None) -> Tuple[torch.Tensor, dict]:
    """One decode step -> (logits (B, V), cache updated in place): the
    verify step at T = 1 (``split`` and ``tp`` a placed decode's, as
    there)."""
    logits, cache, _ = verify_step(params, cache, tokens[:, None], position,
                                   cfg, split, tp)
    return logits[:, 0], cache


def decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      position: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step against the paged pool (updated in place): the
    paged verify step at T = 1."""
    logits, cache, _ = verify_step_paged(params, cache, tokens[:, None],
                                         position, block_tables, cfg)
    return logits[:, 0], cache
