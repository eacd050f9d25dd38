"""Decoder-only transformer LM (port of :mod:`repro.models.transformer`,
dense-MLP layers; MoE waits).

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
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (
    ModelConfig,
    cross_entropy,
    embed_init,
    embed_lookup,
    init_rms_norm,
    rms_norm,
    unembed,
)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP.md)")


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_params(layers: dict, i: int) -> dict:
    """Views of layer ``i`` of the stacked layer parameters."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def init_layer(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> dict:
    return {
        "norm1": init_rms_norm(cfg.d_model, dtype, device),
        "attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "norm2": init_rms_norm(cfg.d_model, dtype, device),
        "mlp": mlp_mod.init_mlp(gen, cfg, None, dtype, device),
    }


def init(gen: torch.Generator, cfg: ModelConfig,
         device=DEFAULT_DEVICE) -> dict:
    """Random parameters (same shapes and distributions as the reference,
    different numbers: the draws come from ``gen``)."""
    _check_family(cfg)
    dtype = cfg.param_dtype
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    layers = _stack([init_layer(gen, cfg, dtype, device)
                     for _ in range(cfg.n_layers)])
    return {"embed": embed, "layers": layers,
            "final_norm": init_rms_norm(cfg.d_model, dtype, device)}


def _ffn(layer: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, layer["norm2"]["scale"], cfg.norm_eps)
    return x + mlp_mod.mlp(layer["mlp"], h, cfg)


def _layer_fn(layer: dict, x: torch.Tensor, positions: torch.Tensor,
              window: int, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
    out, _, _ = attn_mod.attention_prefill(layer["attn"], h, positions,
                                           window, cfg)
    return _ffn(layer, x + out, cfg)


def backbone(params: dict, x: torch.Tensor, positions: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The stacked layers and the final norm over x (B, S, D).  Under
    ``cfg.remat`` with grad enabled each layer saves only its input and is
    recomputed whole in the backward (no early stop), as the reference's
    ``jax.checkpoint(..., nothing_saveable)``."""
    windows = cfg.layer_windows()
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        if remat:
            x = checkpoint(_layer_fn, layer, x, positions, int(windows[i]),
                           cfg, use_reentrant=False, early_stop=False)
        else:
            x = _layer_fn(layer, x, positions, int(windows[i]), cfg)
    return rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None].expand(b, s)


def apply(params: dict, tokens: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    """Full-sequence forward -> fp32 logits (B, S, V)."""
    _check_family(cfg)
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    x = backbone(params, x, _positions(tokens), cfg)
    return unembed(params["embed"], x)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy over ``batch["tokens"]`` (B, S) against
    ``batch["labels"]``; positions with label < 0 are masked."""
    _check_family(cfg)
    if batch.get("frontend_embeds") is not None:
        raise NotImplementedError(
            "modality frontends are not ported yet (ROADMAP.md)")
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    x = backbone(params, x, _positions(tokens), cfg)
    logits = unembed(params["embed"], x)
    return cross_entropy(logits, batch["labels"], cfg)


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


def prefill(params: dict, cache: dict, tokens: torch.Tensor,
            cfg: ModelConfig, lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Forward over right-padded prompts -> (logits (B, S, V), a NEW
    cache shaped like ``cache`` holding each row's prompt K/V, zero at
    and beyond its length)."""
    _check_family(cfg)
    b, s = tokens.shape
    smax = cache["k"].shape[2]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32,
                             device=tokens.device)
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    windows = cfg.layer_windows()
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
        out, k, v = attn_mod.attention_prefill(layer["attn"], h, positions,
                                               int(windows[i]), cfg)
        x = _ffn(layer, x + out, cfg)
        ck, cv = attn_mod.scatter_prefill_kv(k, v, lengths, smax)
        ks.append(ck)
        vs.append(cv)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(params["embed"], x)
    return logits, {"k": torch.stack(ks).to(cache["k"].dtype),
                    "v": torch.stack(vs).to(cache["v"].dtype)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, dict]:
    """One decode step -> (logits (B, V), cache updated in place)."""
    _check_family(cfg)
    x = embed_lookup(params["embed"], tokens[:, None], cfg.compute_dtype)
    windows = cfg.layer_windows()
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
        out, _, _ = attn_mod.attention_decode(
            layer["attn"], h, cache["k"][i], cache["v"][i], position,
            int(windows[i]), cfg)
        x = _ffn(layer, x + out, cfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x)[:, 0], cache


def decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      position: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step against the paged pool (updated in place)."""
    _check_family(cfg)
    x = embed_lookup(params["embed"], tokens[:, None], cfg.compute_dtype)
    windows = cfg.layer_windows()
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
        out, _, _ = attn_mod.attention_decode_paged(
            layer["attn"], h, cache["k_pages"][i], cache["v_pages"][i],
            block_tables, position, int(windows[i]), cfg)
        x = _ffn(layer, x + out, cfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x)[:, 0], cache
