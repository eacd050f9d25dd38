"""Grouped-query attention with RoPE, qk-norm, sliding windows and KV
caches (port of the self-attention half of :mod:`repro.models.attention`).

Prefill runs flash-structured (online softmax over KV chunks) or plain
SDPA per ``cfg.attn_impl``; decode appends one token to a dense
``(B, Smax, Hkv, Dh)`` cache slice, or — paged — writes through the
block table and attends with the paged-attention kernel.  Caches are
updated IN PLACE (the reference returns new arrays; the port keeps one
buffer and says so in each function).  Windows are host ints per layer
(0 = global).  Cross-attention and the speculative verify path are not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as paged_attn_mod
from repro_torch.models import linear
from repro_torch.models.common import (
    ModelConfig,
    apply_rope,
    causal_window_mask,
    init_rms_norm,
    rms_norm,
)


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, device=DEFAULT_DEVICE) -> dict:
    dh = cfg.head_dim_
    d = cfg.d_model
    p = {
        "wq": linear.linear_init(gen, d, cfg.n_heads * dh, cfg, "attn_qkv",
                                 dtype, device),
        "wk": linear.linear_init(gen, d, cfg.n_kv_heads * dh, cfg,
                                 "attn_qkv", dtype, device),
        "wv": linear.linear_init(gen, d, cfg.n_kv_heads * dh, cfg,
                                 "attn_qkv", dtype, device),
        "wo": linear.linear_init(gen, cfg.n_heads * dh, d, cfg, "attn_out",
                                 dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(dh, dtype, device)
        p["k_norm"] = init_rms_norm(dh, dtype, device)
    return p


def _project_qkv(params: dict, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ModelConfig):
    dh = cfg.head_dim_
    d = cfg.d_model
    q = linear.linear_apply(params["wq"], xq, d, cfg.n_heads * dh, cfg,
                            "attn_qkv")
    k = linear.linear_apply(params["wk"], xkv, d, cfg.n_kv_heads * dh, cfg,
                            "attn_qkv")
    v = linear.linear_apply(params["wv"], xkv, d, cfg.n_kv_heads * dh, cfg,
                            "attn_qkv")
    q = q.reshape(*xq.shape[:-1], cfg.n_heads, dh)
    k = k.reshape(*xkv.shape[:-1], cfg.n_kv_heads, dh)
    v = v.reshape(*xkv.shape[:-1], cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"]["scale"], cfg.norm_eps)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """q (B, Sq, Hq, Dh), k/v (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh)."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * (dh ** -0.5)
    if cfg.attn_logit_softcap > 0:
        cap = cfg.attn_logit_softcap
        scores = cap * torch.tanh(scores / cap)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, window: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """Online softmax over KV chunks of ``cfg.attn_chunk`` keys (same
    math as :func:`_sdpa`, never the whole score matrix)."""
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    group = hq // hkv
    chunk = min(cfg.attn_chunk, sk)
    n_chunks = -(-sk // chunk)
    qg = q.reshape(b, sq, hkv, group, dh).float()
    scale = dh ** -0.5
    m = torch.full((b, hkv, group, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, group, sq), device=q.device)
    acc = torch.zeros((b, hkv, group, sq, dh), device=q.device)
    for idx in range(n_chunks):
        start = idx * chunk
        kc = k[:, start:start + chunk]
        vc = v[:, start:start + chunk]
        kp = torch.arange(start, start + kc.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.float()) * scale
        if cfg.attn_logit_softcap > 0:
            cap = cfg.attn_logit_softcap
            s = cap * torch.tanh(s / cap)
        msk = causal_window_mask(positions, kp[None, :], window)
        s = torch.where(msk[:, None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vc.float())
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype)


def attention_prefill(params: dict, x: torch.Tensor,
                      positions: torch.Tensor, window: int,
                      cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention over a whole prompt, returning post-RoPE K/V
    for the cache: x (B, S, D) -> (out (B, S, D), k, v (B, S, Hkv, Dh))."""
    q, k, v = _project_qkv(params, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    if cfg.attn_impl == "chunked":
        out = _sdpa_chunked(q, k, v, positions, window, cfg)
    else:
        mask = causal_window_mask(positions, positions, window)
        out = _sdpa(q, k, v, mask, cfg)
    dh = cfg.head_dim_
    out = out.reshape(*x.shape[:-1], cfg.n_heads * dh)
    out = linear.linear_apply(params["wo"], out, cfg.n_heads * dh,
                              cfg.d_model, cfg, "attn_out")
    return out, k, v


def scatter_prefill_kv(k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, max_len: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lay prompt K/V into a fresh (B, max_len, Hkv, Dh) slab, zero at
    and beyond each row's length."""
    b, s = k.shape[:2]
    valid = (torch.arange(max_len, device=k.device)[None, :]
             < lengths[:, None])[:, :, None, None]
    pad = (0, 0, 0, 0, 0, max_len - s)
    kz = torch.nn.functional.pad(k, pad)
    vz = torch.nn.functional.pad(v, pad)
    return (torch.where(valid, kz, torch.zeros_like(kz)),
            torch.where(valid, vz, torch.zeros_like(vz)))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: int, dtype, device=DEFAULT_DEVICE) -> dict:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_kv_cache_paged(cfg: ModelConfig, n_blocks: int, block_size: int,
                        n_layers: int, dtype, device=DEFAULT_DEVICE) -> dict:
    """Global page pool; page ``n_blocks`` is the write sink (trash)."""
    shape = (n_layers, n_blocks + 1, block_size, cfg.n_kv_heads,
             cfg.head_dim_)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def scatter_prefill_pages(pages: torch.Tensor, slab: torch.Tensor,
                          phys_blocks: torch.Tensor) -> torch.Tensor:
    """Paged prefill scatter IN PLACE: lay a batch-1 dense slab
    (L, 1, S, ...) into the pool (L, NB+1, bs, ...) through
    ``phys_blocks`` (S // bs,), whose unmapped entries already point at
    the trash page.  Whole pages are overwritten."""
    n_layers, s = slab.shape[0], slab.shape[2]
    bs = pages.shape[2]
    vals = slab[:, 0].reshape(n_layers, s // bs, bs, *slab.shape[3:])
    pages[:, phys_blocks.long()] = vals.to(pages.dtype)
    return pages


def attention_decode(params: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, position: torch.Tensor,
                     window: int, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token per row against the dense cache slice (B, Smax, Hkv, Dh),
    written IN PLACE at ``position``; rows parked at ``position >= Smax``
    write nothing.  Returns (out (B, 1, D), cache_k, cache_v)."""
    b = x.shape[0]
    smax = cache_k.shape[1]
    q, k, v = _project_qkv(params, x, x, cfg)
    pos2 = position[:, None]
    q = apply_rope(q, pos2, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, pos2, cfg.rope_fraction, cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    idx = torch.clamp(position.long(), max=smax - 1)
    live = (position < smax)[:, None, None]
    cache_k[rows, idx] = torch.where(live, k[:, 0].to(cache_k.dtype),
                                     cache_k[rows, idx])
    cache_v[rows, idx] = torch.where(live, v[:, 0].to(cache_v.dtype),
                                     cache_v[rows, idx])
    k_pos = torch.arange(smax, device=x.device)[None, :]
    mask = causal_window_mask(pos2, k_pos, window)          # (B, 1, Smax)
    out = _sdpa(q, cache_k, cache_v, mask, cfg)
    dh = cfg.head_dim_
    out = out.reshape(b, 1, cfg.n_heads * dh)
    out = linear.linear_apply(params["wo"], out, cfg.n_heads * dh,
                              cfg.d_model, cfg, "attn_out")
    return out, cache_k, cache_v


def _attention_paged(params: dict, x: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_tables: torch.Tensor,
                     position: torch.Tensor, window: int, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged decode body (decode is T=1): the T new tokens' K/V go into
    their tail pages IN PLACE (trash when unmapped or parked) and the
    paged-attention kernel attends over the mapped prefix plus the new
    tokens.  On CPU tensors the kernel's plain version runs."""
    b, t, _ = x.shape
    dh = cfg.head_dim_
    q, k, v = _project_qkv(params, x, x, cfg)
    pos = position[:, None] + torch.arange(t, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_fraction, cfg.rope_theta)
    ops.paged_attn_route(cfg.n_kv_heads, dh, cfg.n_heads // cfg.n_kv_heads,
                         t, q.device)
    out = paged_attn_mod.paged_attention(
        q, k, v, k_pages, v_pages, block_tables, position, window,
        softcap=cfg.attn_logit_softcap)
    out = out.reshape(b, t, cfg.n_heads * dh)
    out = linear.linear_apply(params["wo"], out, cfg.n_heads * dh,
                              cfg.d_model, cfg, "attn_out")
    return out, k_pages, v_pages


def attention_decode_paged(params: dict, x: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           position: torch.Tensor, window: int,
                           cfg: ModelConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Paged twin of :func:`attention_decode` (the T=1 case)."""
    return _attention_paged(params, x, k_pages, v_pages, block_tables,
                            position, window, cfg)
