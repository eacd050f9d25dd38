"""Encoder-decoder transformer (port of :mod:`repro.models.encdec`):
Seamless-M4T-v2's text/audio backbone.

The modality frontend is a STUB, as in the reference: precomputed audio
frame embeddings (B, F, D) feed a bidirectional encoder; the decoder is
a causal transformer with cross-attention over the encoder states.
Encoder and decoder layers are stacked with a leading L axis
(``encoder/attn/wo/sell/a`` is ``(L_enc, K, N)``), keyed like the
reference pytree, and looped over in Python as in
:mod:`repro_torch.models.transformer`.

Decode caches the decoder's self-attention K/V (dense ``k``/``v`` or
paged ``k_pages``/``v_pages``) and, dense and batch-indexed in both
layouts, the cross-attention K/V (``xk``/``xv``, (L, B, frames, Hkv,
Dh)) computed once from the encoder output at prefill.  The decode step
is the verify at T = 1 and every self-attention write SETS its row
(:mod:`repro_torch.models.attention`).

**Frames.**  The cross cache holds ``n_frontend_tokens or 128`` frames a
slot, as the reference's; a request may bring fewer (the serve launcher
gives 16).  The reference writes them into the slot's leading frames and
attends over all of them afterwards, the zero rest included, so its
decode departs from its own ``apply`` whenever the frames do not fill
the cache.  The port keeps a per-slot frame count ``xlen`` (B,) int32 in
the cache, set at prefill, and :func:`_cross_attend` masks the keys at
and beyond it.  When the frames fill the cache the mask is all true and
the function is the reference's.

**Tensor parallelism.**  Under ``tp`` (a placed train, prefill or
decode step's :class:`repro_torch.dist.sharding.TensorSplit`) every
attention, the encoder's, the decoder's self- and cross-attention,
projects and attends this rank's query and KV heads and completes its
output over "model" through ``wo``'s rows; the GeGLU MLP computes its
ffn columns; the embedding and the logits are this rank's block of the
vocabulary where it splits.  The encoder states feed every decoder
layer's cross K/V, whose columns split, so they pass through
``tp.copy``: their gradient is summed over "model" (each rank computes
the whole encoder).  A prefill's cross K/V are this rank's KV heads, the
block the placed cache holds, and a decode's cross-attention reads them
there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.models import attention as attn_mod
from repro_torch.models import linear
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
from repro_torch.models.transformer import keep, layer_params, run_layer


def init_encoder_layer(gen: torch.Generator, cfg: ModelConfig,
                       dtype=torch.float32, device=DEFAULT_DEVICE) -> dict:
    return {
        "norm1": init_rms_norm(cfg.d_model, dtype, device),
        "attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "norm2": init_rms_norm(cfg.d_model, dtype, device),
        "mlp": mlp_mod.init_mlp(gen, cfg, None, dtype, device),
    }


def init_decoder_layer(gen: torch.Generator, cfg: ModelConfig,
                       dtype=torch.float32, device=DEFAULT_DEVICE) -> dict:
    return {
        "norm1": init_rms_norm(cfg.d_model, dtype, device),
        "attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "norm_x": init_rms_norm(cfg.d_model, dtype, device),
        "cross": attn_mod.init_attention(gen, cfg, dtype, device,
                                         cross=True),
        "norm2": init_rms_norm(cfg.d_model, dtype, device),
        "mlp": mlp_mod.init_mlp(gen, cfg, None, dtype, device),
    }


def init(gen: torch.Generator, cfg: ModelConfig,
         device=DEFAULT_DEVICE) -> dict:
    """Random parameters (the reference's shapes and distributions, drawn
    from ``gen``)."""
    dtype = cfg.param_dtype
    n_enc = cfg.n_encoder_layers or cfg.n_layers
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "encoder": stack_init(n_enc, lambda _: init_encoder_layer(
            gen, cfg, dtype, device)),
        "decoder": stack_init(cfg.n_layers, lambda _: init_decoder_layer(
            gen, cfg, dtype, device)),
        "enc_norm": init_rms_norm(cfg.d_model, dtype, device),
        "final_norm": init_rms_norm(cfg.d_model, dtype, device),
    }


def _run_layers(fn, stacked: dict, n: int, x: torch.Tensor, *args,
                cfg: ModelConfig, tp=None) -> torch.Tensor:
    """``x = fn(layer_i, x, *args, cfg, tp)`` over ``n`` stacked layers;
    under ``cfg.remat`` with grad enabled each layer saves only its input
    and is recomputed whole in the backward (``nothing_saveable``), its
    collectives under ``tp`` with it."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(n):
        x = run_layer(fn, stacked, i, x, *args, cfg, tp, remat=remat)
    return x


def _enc_layer(layer: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Bidirectional encoder layer: the self-attention runs the
    cross-attention path over its own input (no causal mask)."""
    h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
    x = x + attn_mod.attention(layer["attn"], h, positions, 0, cfg,
                               kv=(h,), kv_positions=positions, tp=tp)
    h = rms_norm(x, layer["norm2"]["scale"], cfg.norm_eps)
    return x + mlp_mod.mlp(layer["mlp"], h, cfg, tp=tp)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           tp=None) -> torch.Tensor:
    """frames (B, F, D) stub audio embeddings -> encoder states (B, F, D)
    in the compute dtype (whole on every rank under ``tp``)."""
    b, f, _ = frames.shape
    positions = torch.arange(f, device=frames.device)[None].expand(b, f)
    x = _run_layers(_enc_layer, params["encoder"],
                    cfg.n_encoder_layers or cfg.n_layers,
                    frames.to(cfg.compute_dtype), positions, cfg=cfg, tp=tp)
    return rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)


def _dec_layer(layer: dict, x: torch.Tensor, enc: torch.Tensor,
               positions: torch.Tensor, cfg: ModelConfig,
               tp=None) -> torch.Tensor:
    h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
    x = x + attn_mod.attention(layer["attn"], h, positions, 0, cfg, tp=tp)
    h = rms_norm(x, layer["norm_x"]["scale"], cfg.norm_eps)
    x = x + attn_mod.attention(layer["cross"], h, positions, 0, cfg,
                               kv=(enc,), tp=tp)
    h = rms_norm(x, layer["norm2"]["scale"], cfg.norm_eps)
    return x + mlp_mod.mlp(layer["mlp"], h, cfg, tp=tp)


def apply(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
          frontend_embeds: Optional[torch.Tensor] = None,
          tp=None) -> torch.Tensor:
    """tokens (B, S) decoder input, frontend_embeds (B, F, D) audio stub
    -> fp32 logits (B, S, V); under ``tp`` (see the module's docstring)
    this rank's block of the vocabulary (B, S, V / model) where it
    splits."""
    if frontend_embeds is None:
        raise ValueError("the encoder-decoder needs frontend_embeds")
    enc = encode(params, frontend_embeds, cfg, tp)
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype, tp)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = _run_layers(_dec_layer, params["decoder"], cfg.n_layers, x, enc,
                    positions, cfg=cfg, tp=tp)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x, tp)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            rows=None, tp=None) -> torch.Tensor:
    """Next-token cross-entropy of the decoder over ``batch["tokens"]``
    against ``batch["labels"]``, conditioned on
    ``batch["frontend_embeds"]``; ``rows`` and ``tp`` as in
    :func:`repro_torch.models.transformer.loss_fn`."""
    logits = apply(params, batch["tokens"], cfg, batch["frontend_embeds"],
                   tp)
    return cross_entropy(logits, batch["labels"], cfg, rows, tp)


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------

def _cross_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """Zero cross K/V of ``n_frontend_tokens or 128`` frames a slot, all
    of them counted in ``xlen`` (the reference's cache, unmasked)."""
    frames = cfg.n_frontend_tokens or 128
    shape = (cfg.n_layers, batch, frames, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "xk": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "xv": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "xlen": torch.full((batch,), frames, dtype=torch.int32,
                           device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=DEFAULT_DEVICE) -> dict:
    kv = attn_mod.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                cfg.compute_dtype, device)
    return {**kv, **_cross_cache(cfg, batch, device)}


def init_cache_paged(cfg: ModelConfig, batch: int, n_blocks: int,
                     block_size: int, device=DEFAULT_DEVICE) -> dict:
    """Paged decoder self-attention K/V (one pool).  The cross K/V stays
    dense and batch-indexed: it is written once at prefill and has no
    ragged length to reclaim."""
    kv = attn_mod.init_kv_cache_paged(cfg, n_blocks, block_size,
                                      cfg.n_layers, cfg.compute_dtype,
                                      device)
    return {**kv, **_cross_cache(cfg, batch, device)}


def _cross_kv(cross: dict, enc: torch.Tensor, cfg: ModelConfig, tp=None):
    """One decoder layer's cross K/V (B, F, Hkv, Dh) of encoder states
    ``enc`` (B, F, D), in the compute dtype; under ``tp`` with ``wk`` /
    ``wv`` on their "model" block, this rank's KV heads (B, F, Hkv /
    model, Dh), ``enc`` read through ``tp.copy``."""
    dh, nkv = cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    if tp is not None and linear.splits_out(cross["wk"], nkv):
        enc = tp.copy(enc)
    k = linear.linear_apply(cross["wk"], enc, cfg.d_model, nkv, cfg,
                            "attn_qkv", tp)
    v = linear.linear_apply(cross["wv"], enc, cfg.d_model, nkv, cfg,
                            "attn_qkv", tp)
    shape = (*enc.shape[:-1], k.shape[-1] // dh, dh)
    return (k.reshape(shape).to(cfg.compute_dtype),
            v.reshape(shape).to(cfg.compute_dtype))


def _frame_counts(frames: torch.Tensor) -> torch.Tensor:
    b, f = frames.shape[:2]
    return torch.full((b,), f, dtype=torch.int32, device=frames.device)


def _cross_attend(layer: dict, h: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor, xlen: Optional[torch.Tensor],
                  cfg: ModelConfig, split=None, tp=None) -> torch.Tensor:
    """Cross-attention of (B, T, D) queries over one layer's cached
    encoder K/V (B, F, Hkv, Dh), keys at and beyond ``xlen`` (B,) masked
    (shared by the prefill, decode and verify bodies: T = S, 1, k + 1).
    With ``split`` (a :class:`repro_torch.dist.sharding.LeafSplit`)
    ``xk``/``xv`` are this rank's block of a placed cross cache
    (:func:`repro_torch.models.attention.attend_split`).  Under ``tp``
    with ``wq`` on its "model" block the queries are this rank's heads,
    attended against their KV heads in ``xk``/``xv`` (projected on them,
    or the rank's block of the cache) and completed over "model" by
    ``wo``'s rows (:func:`repro_torch.models.attention.attend_local`)."""
    dh, d = cfg.head_dim_, cfg.d_model
    nq = cfg.n_heads * dh
    wq = layer["cross"]["wq"]
    local = tp is not None and linear.splits_out(wq, nq)
    q = linear.linear_apply(wq, tp.copy(h) if local else h, d, nq, cfg,
                            "attn_qkv", tp)
    q = q.reshape(*h.shape[:-1], q.shape[-1] // dh, dh)
    mask = None
    if xlen is not None:
        keys = attn_mod.key_positions(split, xk.shape[1], h.device)
        mask = (keys[None, :] < xlen[:, None])[:, None, :].expand(
            -1, h.shape[1], -1)
    if local:
        out = attn_mod.attend_local(q, xk, xv, mask, cfg, tp, split)
    elif split is None:
        out = attn_mod._sdpa(q, xk, xv, mask, cfg)
    else:
        out = attn_mod.attend_split(q, xk, xv, mask, cfg, split)
    out = out.reshape(*h.shape[:-1], out.shape[-2] * dh)
    return linear.linear_apply(layer["cross"]["wo"], out, nq, d, cfg,
                               "attn_out", tp)


def _cross_and_mlp(layer: dict, x: torch.Tensor, xk: torch.Tensor,
                   xv: torch.Tensor, xlen: Optional[torch.Tensor],
                   cfg: ModelConfig, split=None, tp=None) -> torch.Tensor:
    """The decoder layer after its self-attention: cross-attention over
    one layer's frames ``xk``/``xv`` (``xlen`` a row; ``split`` and
    ``tp`` as in :func:`_cross_attend`), then the MLP (residuals
    included; its ffn columns under ``tp``)."""
    h = rms_norm(x, layer["norm_x"]["scale"], cfg.norm_eps)
    x = x + _cross_attend(layer, h, xk, xv, xlen, cfg, split, tp)
    h = rms_norm(x, layer["norm2"]["scale"], cfg.norm_eps)
    return x + mlp_mod.mlp(layer["mlp"], h, cfg, tp=tp)


def prefill(params: dict, cache: dict, tokens: torch.Tensor,
            cfg: ModelConfig, lengths: Optional[torch.Tensor] = None,
            frontend_embeds: Optional[torch.Tensor] = None, cut=keep,
            split=None, tp=None) -> Tuple[torch.Tensor, dict]:
    """Batched decoder prompt pass -> (logits (B, S, V), a NEW cache).

    With ``frontend_embeds`` the encoder runs first and each decoder
    layer projects its cross K/V as it comes to it, and the new cache
    holds them with ``xlen`` F a row; otherwise the cache's cross K/V is
    used, the layout :func:`decode_step` reads, so prefill-then-decode
    agrees with a token-at-a-time decode.  The self-attention K/V of each
    row is zero at and beyond its length.  ``cut`` as in
    :func:`repro_torch.models.transformer.prefill` (the cross K/V too,
    when the frames come here).  ``split`` (a placed prefill's
    :class:`repro_torch.dist.sharding.DecodeSplit`) says which block of
    the cache's cross K/V this rank holds, where no frames come.  ``tp``
    (the model-local view's :class:`repro_torch.dist.sharding.TensorSplit`):
    each layer computes on "model" blocks, the new self and cross K/V
    are this rank's KV heads where they split over "model" (the rank's
    block of the cache's cross K/V feeds its own heads where no frames
    come), and the logits this rank's block of the vocabulary
    (B, S, V / model) where it splits."""
    enc = (encode(params, frontend_embeds, cfg, tp)
           if frontend_embeds is not None else None)
    xlen = (_frame_counts(frontend_embeds) if enc is not None
            else cache["xlen"])
    b, s = tokens.shape
    smax = cache["k"].shape[2]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32,
                             device=tokens.device)
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype, tp)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x_split = leaf_split(split, "xk") if enc is None else None
    ks, vs, xks, xvs = [], [], [], []
    for i in range(cfg.n_layers):
        layer = layer_params(params["decoder"], i)
        if enc is not None:
            xk, xv = _cross_kv(layer["cross"], enc, cfg, tp)
        else:
            xk, xv = cache["xk"][i], cache["xv"][i]
        h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
        out, k, v = attn_mod.attention_prefill(layer["attn"], h, positions,
                                               0, cfg, tp)
        x = _cross_and_mlp(layer, x + out, xk, xv, xlen, cfg, x_split, tp)
        ck, cv = attn_mod.scatter_prefill_kv(k, v, lengths, smax)
        local = k.shape[2] < cfg.n_kv_heads
        ks.append(cut("k", ck, local))
        vs.append(cut("v", cv, local))
        if enc is not None:
            local = xk.shape[2] < cfg.n_kv_heads
            xks.append(cut("xk", xk, local))
            xvs.append(cut("xv", xv, local))
        del xk, xv
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(params["embed"], x, tp)
    new = {**cache, "k": torch.stack(ks).to(cache["k"].dtype),
           "v": torch.stack(vs).to(cache["v"].dtype)}
    if enc is not None:
        new.update(xk=torch.stack(xks), xv=torch.stack(xvs), xlen=xlen)
    return logits, new


def verify_step(params: dict, cache: dict, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig, split=None,
                tp=None) -> Tuple[torch.Tensor, dict, None]:
    """Speculative append-and-score of tokens (B, T) at ``position ..
    position + T - 1`` -> (logits (B, T, V), cache, None): the decoder's
    self-attention K/V set-written in place, the cross K/V read only.
    ``split`` (a :class:`repro_torch.dist.sharding.DecodeSplit`) and
    ``tp`` (the model-local view's
    :class:`repro_torch.dist.sharding.TensorSplit`) are a placed
    decode's: both attentions run this rank's query heads on its block
    of the cache (the cross-attention's on the rank's block of ``xk`` /
    ``xv``, ``xlen`` masking kept), the MLP its ffn columns, and the
    logits are this rank's block of the vocabulary where it splits."""
    kv_split, x_split = leaf_split(split, "k"), leaf_split(split, "xk")
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype, tp)
    for i in range(cfg.n_layers):
        layer = layer_params(params["decoder"], i)
        h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
        out, _, _ = attn_mod.attention_verify(
            layer["attn"], h, cache["k"][i], cache["v"][i], position, 0, cfg,
            kv_split, tp)
        x = _cross_and_mlp(layer, x + out, cache["xk"][i], cache["xv"][i],
                           cache["xlen"], cfg, x_split, tp)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x, tp), cache, None


def verify_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      position: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict, None]:
    """Paged twin of :func:`verify_step` (self K/V through the block
    table and the paged-attention kernel); the cross K/V stays dense."""
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    for i in range(cfg.n_layers):
        layer = layer_params(params["decoder"], i)
        h = rms_norm(x, layer["norm1"]["scale"], cfg.norm_eps)
        out, _, _ = attn_mod.attention_verify_paged(
            layer["attn"], h, cache["k_pages"][i], cache["v_pages"][i],
            block_tables, position, 0, cfg)
        x = _cross_and_mlp(layer, x + out, cache["xk"][i], cache["xv"][i],
                           cache["xlen"], cfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x), cache, None


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig, split=None,
                tp=None) -> Tuple[torch.Tensor, dict]:
    """One decode step -> (logits (B, V), cache): the verify at T = 1
    (``split`` and ``tp`` a placed decode's, as there)."""
    logits, cache, _ = verify_step(params, cache, tokens[:, None], position,
                                   cfg, split, tp)
    return logits[:, 0], cache


def decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      position: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One paged decode step: the paged verify at T = 1."""
    logits, cache, _ = verify_step_paged(params, cache, tokens[:, None],
                                         position, block_tables, cfg)
    return logits[:, 0], cache
